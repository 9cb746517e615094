"""AWS Signature Version 4 for the object-store tier — stdlib only (the
port's copy of rabitq_tpu.store.sigv4).

The reference's disk tier authenticates through the AWS SDK credential
chain (env/profile credentials, ranged GetObject requests signed by the
SDK). This module is the dependency-free equivalent: a SigV4 request
signer and presigner, the standard env -> shared-credentials-file
resolution chain, and an ``s3://bucket/key`` range-read source that
plugs into :class:`rabitq_tpu_torch.store.BlockCachedStore` exactly like
``HttpRangeSource`` does.

Scope notes:
- Only header-signed and query-presigned **GET/HEAD** are exercised by
  the store (the index is written locally and uploaded out-of-band), but
  the signer is method-generic and covers signed payloads too.
- No IMDS/STS endpoints (this library never assumes instance metadata —
  and the signing itself is pure computation, testable offline against
  the worked examples in AWS's SigV4 documentation, see
  tests/test_torch_sigv4.py).
"""

from __future__ import annotations

import configparser
import datetime
import hashlib
import hmac
import os
from dataclasses import dataclass
from pathlib import Path
from urllib.parse import urlsplit

ALGORITHM = "AWS4-HMAC-SHA256"
# sha256 of an empty payload — the x-amz-content-sha256 for GET/HEAD.
EMPTY_PAYLOAD_HASH = hashlib.sha256(b"").hexdigest()
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"

_UNRESERVED = frozenset(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-._~"
)


def uri_encode(value: str, *, encode_slash: bool = True) -> str:
    """SigV4 URI encoding: unreserved chars verbatim, everything else
    %XX with uppercase hex; '/' kept only in URI paths."""
    out = []
    for byte in value.encode("utf-8"):
        ch = chr(byte)
        if ch in _UNRESERVED or (ch == "/" and not encode_slash):
            out.append(ch)
        else:
            out.append(f"%{byte:02X}")
    return "".join(out)


def _canonical_uri(path: str) -> str:
    """Each path segment URI-encoded once (S3 semantics: the service
    does NOT double-encode, unlike the generic SigV4 rule)."""
    if not path:
        return "/"
    return "/".join(uri_encode(seg) for seg in path.split("/")) or "/"


def _canonical_query(query: str | list[tuple[str, str]]) -> str:
    if isinstance(query, str):
        pairs = []
        if query:
            for item in query.split("&"):
                k, _, v = item.partition("=")
                pairs.append((k, v))
    else:
        pairs = list(query)
    enc = sorted(
        (uri_encode(k), uri_encode(v)) for k, v in pairs
    )
    return "&".join(f"{k}={v}" for k, v in enc)


def _canonical_headers(headers: dict[str, str]) -> tuple[str, str]:
    """Returns (canonical_headers_block, signed_headers_list)."""
    items = sorted(
        (name.lower(), " ".join(value.strip().split()))
        for name, value in headers.items()
    )
    block = "".join(f"{k}:{v}\n" for k, v in items)
    signed = ";".join(k for k, _ in items)
    return block, signed


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


def signing_key(secret_key: str, datestamp: str, region: str, service: str) -> bytes:
    k = _hmac(("AWS4" + secret_key).encode("utf-8"), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


@dataclass(frozen=True)
class Credentials:
    access_key: str
    secret_key: str
    token: str | None = None


def resolve_credentials(
    env: dict[str, str] | None = None,
    profile: str | None = None,
) -> Credentials:
    """Standard chain: env vars, then the shared credentials file — the
    same order the AWS SDK's default chain starts with (its later
    IMDS/SSO stages need network or daemon access and are out of scope
    by design)."""
    env = dict(os.environ if env is None else env)
    ak = env.get("AWS_ACCESS_KEY_ID")
    sk = env.get("AWS_SECRET_ACCESS_KEY")
    if ak and sk:
        return Credentials(ak, sk, env.get("AWS_SESSION_TOKEN") or None)
    cred_path = Path(
        env.get("AWS_SHARED_CREDENTIALS_FILE", "~/.aws/credentials")
    ).expanduser()
    profile = profile or env.get("AWS_PROFILE", "default")
    if cred_path.exists():
        ini = configparser.ConfigParser()
        ini.read(cred_path)
        if profile in ini:
            sec = ini[profile]
            ak = sec.get("aws_access_key_id")
            sk = sec.get("aws_secret_access_key")
            if ak and sk:
                return Credentials(ak, sk, sec.get("aws_session_token") or None)
    raise RuntimeError(
        "no AWS credentials: set AWS_ACCESS_KEY_ID/AWS_SECRET_ACCESS_KEY "
        f"or add profile {profile!r} to {cred_path}"
    )


def resolve_region(env: dict[str, str] | None = None) -> str:
    env = dict(os.environ if env is None else env)
    return env.get("AWS_REGION") or env.get("AWS_DEFAULT_REGION") or "us-east-1"


class SigV4Signer:
    """Signs HTTP requests with AWS Signature Version 4 (header auth) and
    generates presigned URLs (query auth)."""

    def __init__(
        self,
        credentials: Credentials,
        region: str,
        service: str = "s3",
    ) -> None:
        self.credentials = credentials
        self.region = region
        self.service = service

    # -- shared plumbing -----------------------------------------------------

    def _scope(self, datestamp: str) -> str:
        return f"{datestamp}/{self.region}/{self.service}/aws4_request"

    def _signature(
        self, canonical_request: str, amzdate: str, datestamp: str
    ) -> str:
        string_to_sign = "\n".join(
            (
                ALGORITHM,
                amzdate,
                self._scope(datestamp),
                hashlib.sha256(canonical_request.encode("utf-8")).hexdigest(),
            )
        )
        key = signing_key(
            self.credentials.secret_key, datestamp, self.region, self.service
        )
        return hmac.new(
            key, string_to_sign.encode("utf-8"), hashlib.sha256
        ).hexdigest()

    @staticmethod
    def _now(now: datetime.datetime | None) -> tuple[str, str]:
        if now is None:
            now = datetime.datetime.now(datetime.timezone.utc)
        amzdate = now.strftime("%Y%m%dT%H%M%SZ")
        return amzdate, amzdate[:8]

    # -- header auth ---------------------------------------------------------

    def sign(
        self,
        method: str,
        url: str,
        headers: dict[str, str] | None = None,
        payload_hash: str = EMPTY_PAYLOAD_HASH,
        now: datetime.datetime | None = None,
    ) -> dict[str, str]:
        """Returns the complete header set for the request (input headers
        plus host, x-amz-date, x-amz-content-sha256, the session token if
        any, and Authorization). Every returned header except
        Authorization is part of the signature."""
        parts = urlsplit(url)
        amzdate, datestamp = self._now(now)
        to_sign = {k: v for k, v in (headers or {}).items()}
        to_sign.setdefault("host", parts.netloc)
        to_sign["x-amz-content-sha256"] = payload_hash
        to_sign["x-amz-date"] = amzdate
        if self.credentials.token:
            to_sign["x-amz-security-token"] = self.credentials.token
        header_block, signed_headers = _canonical_headers(to_sign)
        canonical = "\n".join(
            (
                method.upper(),
                _canonical_uri(parts.path),
                _canonical_query(parts.query),
                header_block,
                signed_headers,
                payload_hash,
            )
        )
        sig = self._signature(canonical, amzdate, datestamp)
        auth = (
            f"{ALGORITHM} "
            f"Credential={self.credentials.access_key}/{self._scope(datestamp)}, "
            f"SignedHeaders={signed_headers}, Signature={sig}"
        )
        out = dict(to_sign)
        out["Authorization"] = auth
        return out

    # -- query (presigned URL) auth -------------------------------------------

    def presign(
        self,
        method: str,
        url: str,
        expires: int = 3600,
        now: datetime.datetime | None = None,
    ) -> str:
        """Presigned-URL form (the auth mode HttpRangeSource's docstring
        points external signers at — this IS that signer). S3 presigned
        URLs always use UNSIGNED-PAYLOAD and sign only the host header."""
        parts = urlsplit(url)
        amzdate, datestamp = self._now(now)
        header_block, signed_headers = _canonical_headers(
            {"host": parts.netloc}
        )
        qs: list[tuple[str, str]] = []
        if parts.query:
            for item in parts.query.split("&"):
                k, _, v = item.partition("=")
                qs.append((k, v))
        qs += [
            ("X-Amz-Algorithm", ALGORITHM),
            (
                "X-Amz-Credential",
                f"{self.credentials.access_key}/{self._scope(datestamp)}",
            ),
            ("X-Amz-Date", amzdate),
            ("X-Amz-Expires", str(int(expires))),
            ("X-Amz-SignedHeaders", signed_headers),
        ]
        if self.credentials.token:
            qs.append(("X-Amz-Security-Token", self.credentials.token))
        canonical = "\n".join(
            (
                method.upper(),
                _canonical_uri(parts.path),
                _canonical_query(qs),
                header_block,
                signed_headers,
                UNSIGNED_PAYLOAD,
            )
        )
        sig = self._signature(canonical, amzdate, datestamp)
        query = _canonical_query(qs) + "&X-Amz-Signature=" + sig
        return f"{parts.scheme}://{parts.netloc}{parts.path or '/'}?{query}"


# -- s3:// URL plumbing --------------------------------------------------------


def parse_s3_url(url: str) -> tuple[str, str]:
    """s3://bucket/key/with/slashes -> (bucket, key)."""
    parts = urlsplit(url)
    if parts.scheme != "s3" or not parts.netloc:
        raise ValueError(f"not an s3:// URL: {url!r}")
    return parts.netloc, parts.path.lstrip("/")


def s3_https_url(
    bucket: str,
    key: str,
    region: str,
    endpoint: str | None = None,
) -> str:
    """Virtual-hosted-style URL on AWS; path-style on a custom endpoint
    (minio/ceph/localstack convention)."""
    key = uri_encode(key, encode_slash=False)
    if endpoint:
        return f"{endpoint.rstrip('/')}/{bucket}/{key}"
    host = (
        f"{bucket}.s3.amazonaws.com"
        if region == "us-east-1"
        else f"{bucket}.s3.{region}.amazonaws.com"
    )
    return f"https://{host}/{key}"


def resolve_endpoint(env: dict[str, str] | None = None) -> str | None:
    env = dict(os.environ if env is None else env)
    return env.get("AWS_ENDPOINT_URL_S3") or env.get("AWS_ENDPOINT_URL")


class S3RangeSource:
    """Range-read source over ``s3://bucket/key`` with per-request SigV4
    signatures — the drop-in credentialed sibling of HttpRangeSource.
    Credentials/region/endpoint resolve from the standard env chain
    unless given explicitly."""

    def __init__(
        self,
        s3_url: str,
        size: int | None = None,
        *,
        credentials: Credentials | None = None,
        region: str | None = None,
        endpoint: str | None = None,
        env: dict[str, str] | None = None,
        retries: int = 4,
        backoff: float = 0.05,
    ) -> None:
        import urllib.request

        self._urllib = urllib.request
        self._retries = retries
        self._backoff = backoff
        bucket, key = parse_s3_url(s3_url)
        region = region or resolve_region(env)
        endpoint = endpoint or resolve_endpoint(env)
        creds = credentials or resolve_credentials(env)
        self._signer = SigV4Signer(creds, region)
        self._url = s3_https_url(bucket, key, region, endpoint)
        if size is None:
            req = self._request("HEAD")
            with self._urllib.urlopen(req) as resp:
                size = int(resp.headers["Content-Length"])
        self.size = size

    def _request(self, method: str, headers: dict[str, str] | None = None):
        signed = self._signer.sign(method, self._url, headers=headers)
        return self._urllib.Request(self._url, method=method, headers=signed)

    def read_range(self, start: int, length: int) -> bytes:
        from rabitq_tpu_torch.store.vector_store import retry_range_read

        return retry_range_read(
            lambda: self._read_once(start, length),
            what=f"{start}+{length} of {self._url}",
            attempts=self._retries,
            backoff=self._backoff,
        )

    def _read_once(self, start: int, length: int) -> bytes:
        # Signatures are minted per attempt (a retry after backoff gets a
        # fresh x-amz-date — a stale one can cross the clock-skew window).
        req = self._request(
            "GET", {"Range": f"bytes={start}-{start + length - 1}"}
        )
        with self._urllib.urlopen(req) as resp:
            body = resp.read()
            if resp.status == 206:
                if len(body) != length:
                    raise ConnectionError(
                        f"range read {start}+{length} of {self._url}: "
                        f"206 with {len(body)} bytes"
                    )
                return body
        # Same whole-object fallback as HttpRangeSource: a 200 with the
        # full body must be sliced, never returned as-is (every block
        # would silently parse as block 0 — corrupt rerank results).
        if resp.status == 200 and len(body) >= start + length:
            return body[start : start + length]
        raise OSError(
            f"range read {start}+{length} of {self._url}: got status "
            f"{resp.status} with {len(body)} bytes"
        )


def s3_get_object(
    s3_url: str,
    *,
    credentials: Credentials | None = None,
    region: str | None = None,
    endpoint: str | None = None,
    env: dict[str, str] | None = None,
) -> bytes | None:
    """Whole-object GET for the metadata bootstrap; None on 404 (the
    caller decides whether the file was optional)."""
    import urllib.error
    import urllib.request

    bucket, key = parse_s3_url(s3_url)
    region = region or resolve_region(env)
    endpoint = endpoint or resolve_endpoint(env)
    creds = credentials or resolve_credentials(env)
    url = s3_https_url(bucket, key, region, endpoint)
    signed = SigV4Signer(creds, region).sign("GET", url)
    req = urllib.request.Request(url, headers=signed)
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise

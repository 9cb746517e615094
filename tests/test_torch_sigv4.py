"""The port's SigV4 signer and S3 range source
(rabitq_tpu_torch.store.sigv4) against the JAX package's.

Both signers get the worked examples of AWS's Signature Version 4
documentation that tests/test_sigv4.py checks (the documented credential
pair, bucket ``examplebucket``, 2013-05-24T00:00:00Z), then seeded random
requests (methods, unicode and reserved characters in paths and queries,
extra headers, payload hashes, session tokens, regions, instants): the
header sets, the Authorization header included, and the presigned URLs
must be equal. The port's S3RangeSource then reads through a local server
that verifies every signature (tests/test_sigv4.py's), and the credentialed
store tier end to end equals the JAX package's.
"""

import datetime
import hashlib

import numpy as np
import pytest

import rabitq_tpu.store.sigv4 as jsig
import rabitq_tpu_torch.store.sigv4 as tsig
from test_sigv4 import AK, SK, T0, _sigv4_verifying_server

AWS_EXAMPLES = {
    "get_range": ("GET", "https://examplebucket.s3.amazonaws.com/test.txt",
                  {"Range": "bytes=0-9"}, jsig.EMPTY_PAYLOAD_HASH),
    "lifecycle": ("GET", "https://examplebucket.s3.amazonaws.com/?lifecycle",
                  None, jsig.EMPTY_PAYLOAD_HASH),
    "list": ("GET",
             "https://examplebucket.s3.amazonaws.com/?max-keys=2&prefix=J",
             None, jsig.EMPTY_PAYLOAD_HASH),
    "put": ("PUT", "https://examplebucket.s3.amazonaws.com/test$file.text",
            {"Date": "Fri, 24 May 2013 00:00:00 GMT",
             "x-amz-storage-class": "REDUCED_REDUNDANCY"},
            hashlib.sha256(b"Welcome to Amazon S3.").hexdigest()),
}


def signers(token=None, region="us-east-1"):
    return [mod.SigV4Signer(mod.Credentials(AK, SK, token), region)
            for mod in (jsig, tsig)]


@pytest.mark.parametrize("name", list(AWS_EXAMPLES))
def test_aws_examples_sign_alike(name):
    method, url, headers, payload_hash = AWS_EXAMPLES[name]
    j, t = (s.sign(method, url, headers=headers, payload_hash=payload_hash,
                   now=T0) for s in signers())
    assert t == j
    if name == "get_range":  # the documented signature itself
        assert t["Authorization"].endswith(
            "f0e8bdb87c964420e857bd35b5d6ed310bd44f0170aba48dd91039c6036bdb41")


def test_aws_presigned_example_alike():
    j, t = (s.presign("GET", "https://examplebucket.s3.amazonaws.com/test.txt",
                      expires=86400, now=T0) for s in signers())
    assert t == j
    assert t.endswith("aeeed9bbccd4d02ee5c0109b86d86835f995330da4c265957d157"
                      "751f604d404")


ALPHABET = list("abcXYZ019-._~ /$&=+%?!'()*,;:@ä€ü") + ["ревность"]


def _word(rng, lo=1, hi=9):
    return "".join(rng.choice(ALPHABET) for _ in range(rng.integers(lo, hi)))


@pytest.mark.parametrize("seed", range(6))
def test_random_requests_sign_alike(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        token = _word(rng) if rng.random() < 0.4 else None
        region = str(rng.choice(["us-east-1", "eu-north-1", "ap-south-2"]))
        now = T0 + datetime.timedelta(seconds=int(rng.integers(0, 10**9)))
        path = "/".join(tsig.uri_encode(_word(rng), encode_slash=False)
                        for _ in range(rng.integers(1, 4)))
        query = "&".join(f"{_word(rng, 1, 5)}={_word(rng, 0, 5)}"
                         .replace("&", "").replace("?", "")
                         for _ in range(rng.integers(0, 3)))
        url = f"https://bkt.s3.amazonaws.com/{path}" + (
            f"?{query}" if query else "")
        headers = {f"x-amz-meta-{i}": f"  {_word(rng)}  {_word(rng)} "
                   for i in range(rng.integers(0, 3))}
        method = str(rng.choice(["GET", "HEAD", "PUT", "post"]))
        payload = hashlib.sha256(_word(rng).encode()).hexdigest()
        j, t = (s.sign(method, url, headers=headers, payload_hash=payload,
                       now=now) for s in signers(token, region))
        assert t == j, url
        expires = int(rng.integers(1, 10**5))
        j, t = (s.presign(method, url, expires=expires, now=now)
                for s in signers(token, region))
        assert t == j, url
        word = _word(rng)
        for slash in (True, False):
            assert (tsig.uri_encode(word, encode_slash=slash)
                    == jsig.uri_encode(word, encode_slash=slash))


def test_url_and_credential_helpers_alike(tmp_path):
    for url in ("s3://bkt/a/b.fvecs", "s3://b/k"):
        assert tsig.parse_s3_url(url) == jsig.parse_s3_url(url)
    for mod in (jsig, tsig):
        with pytest.raises(ValueError):
            mod.parse_s3_url("http://bkt/a")
    for args in (("bkt", "a/b c.fvecs", "us-east-1"),
                 ("bkt", "k", "eu-west-1"),
                 ("bkt", "k", "us-east-1", "http://localhost:9000/")):
        assert tsig.s3_https_url(*args) == jsig.s3_https_url(*args)
    cred = tmp_path / "credentials"
    cred.write_text("[default]\naws_access_key_id = FA\n"
                    "aws_secret_access_key = FS\n[alt]\naws_access_key_id = "
                    "XA\naws_secret_access_key = XS\naws_session_token = XT\n")
    envs = [{"AWS_ACCESS_KEY_ID": "A", "AWS_SECRET_ACCESS_KEY": "S",
             "AWS_SESSION_TOKEN": "T", "AWS_REGION": "eu-north-1"},
            {"AWS_SHARED_CREDENTIALS_FILE": str(cred),
             "AWS_DEFAULT_REGION": "sa-east-1", "AWS_ENDPOINT_URL": "http://x"},
            {"AWS_SHARED_CREDENTIALS_FILE": str(cred), "AWS_PROFILE": "alt",
             "AWS_ENDPOINT_URL_S3": "http://y"}]
    for env in envs:
        j = jsig.resolve_credentials(env)
        t = tsig.resolve_credentials(env)
        assert (t.access_key, t.secret_key, t.token) == (
            j.access_key, j.secret_key, j.token)
        assert tsig.resolve_region(env) == jsig.resolve_region(env)
        assert tsig.resolve_endpoint(env) == jsig.resolve_endpoint(env)
    with pytest.raises(RuntimeError):
        tsig.resolve_credentials(
            {"AWS_SHARED_CREDENTIALS_FILE": str(tmp_path / "nope")})


def test_s3_range_source_against_verifying_server():
    blob = bytes(range(256)) * 64  # 16 KiB
    failures = []
    srv = _sigv4_verifying_server({"base.fvecs": blob}, failures)
    try:
        src = tsig.S3RangeSource(
            "s3://bkt/base.fvecs",
            credentials=tsig.Credentials(AK, SK),
            region="us-east-1",
            endpoint=f"http://127.0.0.1:{srv.server_port}",
            env={},
        )
        assert src.size == len(blob)
        assert src.read_range(0, 10) == blob[:10]
        assert src.read_range(777, 123) == blob[777 : 777 + 123]
        assert tsig.s3_get_object(
            "s3://bkt/missing", credentials=tsig.Credentials(AK, SK),
            region="us-east-1",
            endpoint=f"http://127.0.0.1:{srv.server_port}", env={}) is None
        assert not failures, failures
    finally:
        srv.shutdown()
        srv.server_close()


def test_s3_store_tier_matches_jax(tmp_path, monkeypatch):
    """The credentialed store tier end to end: the metadata bootstrap over
    s3:// and signed range reads for the rerank, credentials from the env
    chain; the port's result equals the JAX package's bit for bit."""
    import jax

    import rabitq_tpu as rq
    import rabitq_tpu_torch as rt
    from rabitq_tpu import store as jstore
    from rabitq_tpu.index import serialize as jser
    from rabitq_tpu_torch import store as tstore
    from rabitq_tpu_torch.index import serialize as tser

    rng = np.random.default_rng(7)
    k, n, dim = 8, 700, 24
    centers = rng.standard_normal((k, dim)).astype(np.float32)
    base = (centers[rng.integers(0, k, n)]
            + 0.1 * rng.standard_normal((n, dim))).astype(np.float32)
    jidx = rq.build_index(base, centers, key=jax.random.key(3))
    remote = tmp_path / "remote"
    jser.dump_to_dir(jidx, remote)
    files = {f"idx/{p.name}": p.read_bytes() for p in remote.iterdir()}
    failures = []
    srv = _sigv4_verifying_server(files, failures)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", AK)
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", SK)
    monkeypatch.setenv("AWS_REGION", "us-east-1")
    monkeypatch.setenv("AWS_ENDPOINT_URL",
                       f"http://127.0.0.1:{srv.server_port}")
    try:
        local = tmp_path / "local"
        tstore.download_meta("s3://bkt/idx", local)
        assert (local / "centroids.fvecs").exists()
        assert not (local / "base.fvecs").exists()
        tl = tser.load_from_dir(local, keep_base=False, device="cpu")
        jl = jser.load_from_dir(remote, keep_base=False)
        qs = base[5:9]
        t = tstore.search_with_store(
            tl, qs, rt.SearchParams(probe=8, topk=3, rerank=64,
                                    select_reduce=False),
            tstore.BlockCachedStore(
                tstore.S3RangeSource("s3://bkt/idx/base.fvecs"), tl.dim))
        j = jstore.search_with_store(
            jl, qs, rq.SearchParams(probe=8, topk=3, rerank=64,
                                    approx_select=False),
            jstore.MmapStore(remote / "base.fvecs"))
        np.testing.assert_array_equal(t[1], j[1])
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1][:, 0], np.arange(5, 9))
        assert not failures, failures
    finally:
        srv.shutdown()
        srv.server_close()

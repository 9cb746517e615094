"""Two OS processes form one torch.distributed world and search one
sharded index together (the port's twin of tools/multihost_demo.py).

Each worker:

  1. init_distributed(localhost:<port>, 2, pid) with the backend asked for
     (gloo by default; NCCL needs one card a rank);
  2. builds the same index from the same seed, and a mesh of 4 shards on
     ``--device`` (the card unless the CPU is asked for) of which it owns 2;
  3. shard_index + sharded_search(exact=True) over the world: the
     per-shard results are all-gathered over the process group;
  4. holds the result against the single-process sharded search of the
     same index (all 4 shards in this process): ids and distances equal,
     and recall against brute force at least the unsharded search's.

Every worker prints PARITY OK and exits 0. Usage:

  python -m rabitq_tpu_torch.tools.multihost_demo [--device cuda|cpu]
      [--backend gloo|nccl]      # parent: spawns the 2 workers

Without ``--device`` it runs on the card, and raises when there is none.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

NPROC = 2
SHARDS = 4
# Each worker's wait on the world (init and collectives), and the parent's
# on its workers.
TIMEOUT_S = 90


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def worker(pid: int, port: int, device: str, backend: str) -> None:
    import torch
    import torch.distributed as dist

    import rabitq_tpu_torch as rt
    from rabitq_tpu_torch.parallel import (
        Mesh,
        init_distributed,
        make_mesh,
        shard_index,
        sharded_search,
    )

    ok = init_distributed(f"localhost:{port}", NPROC, pid, backend=backend,
                          timeout_s=TIMEOUT_S)
    assert ok and dist.get_world_size() == NPROC
    mesh = make_mesh(devices=[device] * SHARDS)
    log(f"[p{pid}] world up: {NPROC} processes, backend {backend}, shards "
        f"{mesh.local_shards} of {SHARDS} on {device}")

    # The same corpus and build in both processes (same seeds).
    rng = np.random.default_rng(0)
    n, dim, k, nq = 12000, 64, 48, 32
    centers = rng.standard_normal((k, dim)).astype(np.float32)
    base = (centers[rng.integers(0, k, n)]
            + 0.25 * rng.standard_normal((n, dim))).astype(np.float32)
    queries = base[rng.choice(n, nq, replace=False)] + (
        0.05 * rng.standard_normal((nq, dim)).astype(np.float32))
    index = rt.build_index(
        base, centers, spill=0.1, device=device,
        generator=torch.Generator(device=device).manual_seed(3))
    # Full probe and a generous rerank: both arms then return the exact
    # top-10, so the merge over the world is held to the ground truth.
    params = rt.SearchParams(probe=k, topk=10, rerank=1500)
    q = torch.from_numpy(queries).to(device)
    _, i_u = rt.search(index, q, params)

    d_w, i_w = sharded_search(shard_index(index, mesh), q, params, mesh,
                              exact=True)
    solo = Mesh(mesh.devices)  # every shard in this process
    d_1, i_1 = sharded_search(shard_index(index, solo), q, params, solo,
                              exact=True)
    assert torch.equal(i_w.cpu(), i_1.cpu()), "ids differ from one process"
    assert torch.equal(d_w.cpu(), d_1.cpu()), "distances differ"

    truth = np.argsort(((base[None] - queries[:, None]) ** 2).sum(-1),
                       axis=1)[:, :10]

    def recall(ids):
        ids = ids.cpu().numpy()
        return np.mean([len(set(ids[i]) & set(truth[i])) / 10
                        for i in range(nq)])

    rec_w, rec_u = recall(i_w), recall(i_u)
    log(f"[p{pid}] recall against brute force: world {rec_w:.4f}, "
        f"unsharded {rec_u:.4f}")
    assert rec_w >= rec_u >= 0.999, (rec_w, rec_u)
    dist.destroy_process_group()
    print(f"[p{pid}] PARITY OK (recall {rec_w:.4f})", flush=True)


def run(device=None, backend: str = "gloo") -> list[str]:
    """Spawn the two workers and wait for them; returns their standard
    outputs. ``device`` defaults to the card (``resolve_device``). Raises
    if one fails or outlasts TIMEOUT_S."""
    from rabitq_tpu_torch.utils import resolve_device

    device = str(resolve_device(device))
    with socket.socket() as s:  # a free coordinator port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "rabitq_tpu_torch.tools.multihost_demo",
             "--pid", str(pid), "--port", str(port), "--device", device,
             "--backend", backend],
            env=env, cwd=root, stdout=subprocess.PIPE, text=True)
        for pid in range(NPROC)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S + 30)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0] * NPROC:
        raise RuntimeError(f"workers exited {codes}: {outs}")
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    args = ap.parse_args(argv)
    if args.pid is not None:
        worker(args.pid, args.port, args.device, args.backend)
        return
    for out in run(args.device, args.backend):
        sys.stdout.write(out)
    log("multihost demo: every process PARITY OK")


if __name__ == "__main__":
    main()

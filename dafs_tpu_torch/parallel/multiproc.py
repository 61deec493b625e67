"""Several processes under `torch.distributed`: the all-pairs, similarity
and PCT stages with their worklists split over every rank's shards,
gathered with `all_gather`, and held bit for bit to one device's run.

Port of `tools/multiproc.py`.

    python -m dafs_tpu_torch.parallel.multiproc [--nprocs 2] [--local-devices 1]
        [--device cuda|cpu] [--fasta tests/data/RF00005_0.fa] [--timeout 600]

The parent builds the kernel library (on the card), then starts `--nprocs`
fresh interpreters with `subprocess` (never fork) and prints one JSON line:
`ok`, the children's exit codes, and rank 0's report (`processes`,
`global_devices`, `collectives`, `bitwise_equal_pairhmm`,
`bitwise_equal_pct_mp`, `bitwise_equal_pct_bp` and the times).  Each child
owns `--local-devices` shards and joins one process group over
`tcp://127.0.0.1:<free port>`:

- on the CPU, gloo, its shards a virtual mesh on the CPU;
- on cards, when every rank has cards of its own (nprocs * local devices
  at most the visible cards), NCCL, rank r on cards r*K to r*K + K - 1;
- when ranks share cards, gloo over host tensors (NCCL refuses two ranks
  on one GPU), rank r on card r mod count, its shards a virtual mesh there.

Each rank sets its card before any other CUDA call.  The stages, those of
`tools/multiproc.py`: (1) the pair-HMM posteriors of every pair of the
family, the global batch padded to a multiple of the shard count and split
over the world (K1, K2 and the posterior kernel on each shard), then
`all_gather`; (2) the similarity matrix, on each rank; (3) the 3-way and
base-pair PCT over their global worklists, split likewise, then
`all_gather` (the base-pair PCT on random helices from `default_rng(0)`).
Shards are padded to one size, so a tensor `all_gather` suffices.  Rank 0
then runs every stage unsharded on its first device and compares.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FASTA = os.path.join(ROOT, "tests", "data", "RF00005_0.fa")
RESULT = "MULTIPROC_RESULT "


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parent(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's stages over several processes")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--fasta", default=FASTA)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the children may take before they are killed")
    args = ap.parse_args(argv)

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("multiproc: device 'cuda' requested but no CUDA device is available")
        from dafs_tpu_torch.ops import cuda_lib

        cuda_lib.build()  # once, before the children look for it
    port = _free_port()
    procs = []
    for r in range(args.nprocs):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
        env.update(
            DAFS_TORCH_MP_RANK=str(r), DAFS_TORCH_MP_NPROCS=str(args.nprocs),
            DAFS_TORCH_MP_LOCAL=str(args.local_devices), DAFS_TORCH_MP_PORT=str(port),
            DAFS_TORCH_MP_DEVICE=args.device, DAFS_TORCH_MP_FASTA=os.path.abspath(args.fasta),
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dafs_tpu_torch.parallel.multiproc"], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, deadline = [], time.monotonic() + args.timeout
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate()[0] for p in procs]
    rcs = [p.returncode for p in procs]
    result = {"ok": all(rc == 0 for rc in rcs), "rcs": rcs, "nprocs": args.nprocs,
              "local_devices": args.local_devices, "device": args.device}
    report = [line[len(RESULT):] for line in logs[0].splitlines() if line.startswith(RESULT)]
    if report:
        result.update(json.loads(report[-1]))
    result["ok"] = result["ok"] and bool(report) and all(
        result.get(k) for k in ("bitwise_equal_pairhmm", "bitwise_equal_pct_mp",
                                "bitwise_equal_pct_bp"))
    if not result["ok"]:
        result["logs"] = [log[-4000:] for log in logs]
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


def _placement(rank: int, nprocs: int, local: int, device: str):
    """(this rank's shards, backend, the device its collectives use)."""
    if device == "cpu":
        return [torch.device("cpu")] * local, "gloo", torch.device("cpu")
    count = torch.cuda.device_count()
    if count >= nprocs * local:
        cards = [torch.device("cuda", rank * local + k) for k in range(local)]
        return cards, "nccl", cards[0]
    return [torch.device("cuda", rank % count)] * local, "gloo", torch.device("cpu")


def _sync(devices):
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def child() -> int:
    import torch.distributed as dist

    from dafs_tpu_torch import consistency
    from dafs_tpu_torch.fasta import load_fasta
    from dafs_tpu_torch.ops import pairhmm
    from dafs_tpu_torch.parallel import mesh

    rank = int(os.environ["DAFS_TORCH_MP_RANK"])
    nprocs = int(os.environ["DAFS_TORCH_MP_NPROCS"])
    local = int(os.environ["DAFS_TORCH_MP_LOCAL"])
    shards, backend, comm = _placement(rank, nprocs, local, os.environ["DAFS_TORCH_MP_DEVICE"])
    if shards[0].type == "cuda":
        torch.cuda.set_device(shards[0])
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{os.environ['DAFS_TORCH_MP_PORT']}",
        world_size=nprocs, rank=rank, timeout=datetime.timedelta(seconds=300))
    world = nprocs * local

    def gather(outs):
        """This rank's shard outputs, all_gather'ed: every shard's rows in
        global order, on the host."""
        mine = torch.cat([o.to(comm) for o in outs])
        parts = [torch.empty_like(mine) for _ in range(nprocs)]
        dist.all_gather(parts, mine)
        return torch.cat(parts).cpu().numpy()

    fa = load_fasta(os.environ["DAFS_TORCH_MP_FASTA"])
    N = len(fa)
    lens = [len(f.seq) for f in fa]
    L = pairhmm._round_up(max(lens), 32)
    pairs = [(i, j) for i in range(N) for j in range(i + 1, N)]
    Bp, slices = mesh.shard_slices(len(pairs), world)
    mine = slices[rank * local:(rank + 1) * local]
    c1, n1 = pairhmm.encode_batch([fa[i].seq for i, _ in pairs], L)
    c2, n2 = pairhmm.encode_batch([fa[j].seq for _, j in pairs], L)
    host = (mesh.pad_rows(c1, Bp, 0), mesh.pad_rows(n1, Bp, 1),
            mesh.pad_rows(c2, Bp, 0), mesh.pad_rows(n2, Bp, 1))

    # ---- stage 1: all-pairs pair-HMM, the batch split over the world
    t0 = time.perf_counter()
    args = [(tuple(torch.from_numpy(a[sl]).to(d) for a in host), pairhmm.tables(d))
            for d, sl in zip(shards, mine)]
    post = gather([pairhmm.forward_backward_posterior(*a, tab) for a, tab in args])
    t_pairs_sharded = time.perf_counter() - t0

    # ---- stage 2: similarity, on every rank
    mp = np.zeros((N, N, L, L), np.float32)
    for b, (i, j) in enumerate(pairs):
        p = post[b, : lens[i], : lens[j]].copy()
        p[p <= 0.01] = 0.0
        mp[i, j, : lens[i], : lens[j]] = p
        mp[j, i, : lens[j], : lens[i]] = p.T
    for i in range(N):
        mp[i, i, : lens[i], : lens[i]] = np.eye(lens[i], dtype=np.float32)
    sim = consistency.similarity_matrix(mp, lens, shards[0])

    # ---- stage 3: PCT, both worklists split over the world
    bp0 = np.zeros((N, L, L), np.float32)
    rng = np.random.default_rng(0)
    for i in range(N):
        t = np.triu(rng.random((lens[i], lens[i]), dtype=np.float32), 5)
        bp0[i, : lens[i], : lens[i]] = np.where(t > 0.97, t, 0.0)
    _, xs, ys, W, sum_w = consistency.match_worklist(sim, 0.25)
    Pm, mslices = mesh.shard_slices(len(W), world)
    (xs, ys), W, sum_w = consistency.pad_worklist(Pm, (xs, ys), W, sum_w)
    xb, Wb, swb = consistency.basepair_worklist(sim, 0.25)
    Pb, bslices = mesh.shard_slices(len(Wb), world)
    (xb,), Wb, swb = consistency.pad_worklist(Pb, (xb,), Wb, swb)
    t0 = time.perf_counter()
    m = {d: torch.from_numpy(mp).to(d) for d in set(shards)}
    b = {d: torch.from_numpy(bp0).to(d) for d in set(shards)}
    mine = range(rank * local, (rank + 1) * local)
    posts_mp = gather([
        consistency.relax_match_rows(m[d], xs[mslices[g]], ys[mslices[g]], W[mslices[g]],
                                     sum_w[mslices[g]]) for d, g in zip(shards, mine)])
    posts_bp = gather([
        consistency.relax_basepair_rows(b[d], m[d], xb[bslices[g]], Wb[bslices[g]],
                                        swb[bslices[g]]) for d, g in zip(shards, mine)])
    t_pct_sharded = time.perf_counter() - t0

    if rank == 0:
        # ---- the unsharded run on one device, same process
        d = shards[0]
        t0 = time.perf_counter()
        post_ref = pairhmm.forward_backward_posterior(
            *(torch.from_numpy(a).to(d) for a in host), pairhmm.tables(d)).cpu().numpy()
        t_pairs_local = time.perf_counter() - t0
        t0 = time.perf_counter()
        mp_ref = consistency.relax_match_rows(m[d], xs, ys, W, sum_w).cpu().numpy()
        bp_ref = consistency.relax_basepair_rows(b[d], m[d], xb, Wb, swb).cpu().numpy()
        _sync([d])
        t_pct_local = time.perf_counter() - t0
        same = lambda a, b: bool(np.array_equal(a.view(np.int32), b.view(np.int32)))  # noqa: E731
        report = {
            "global_devices": world,
            "processes": nprocs,
            "collectives": backend,
            "shards": [str(s) for s in shards],
            "cards": ([torch.cuda.get_device_name(s) for s in shards]
                      if shards[0].type == "cuda" else []),
            "family": os.path.basename(os.environ["DAFS_TORCH_MP_FASTA"]),
            "pairs": len(pairs),
            "bitwise_equal_pairhmm": same(post, post_ref),
            "bitwise_equal_pct_mp": same(posts_mp, mp_ref),
            "bitwise_equal_pct_bp": same(posts_bp, bp_ref),
            "t_pairs_sharded_s": t_pairs_sharded,
            "t_pairs_local_1dev_s": t_pairs_local,
            "t_pct_sharded_s": t_pct_sharded,
            "t_pct_local_1dev_s": t_pct_local,
        }
        print(RESULT + json.dumps(report), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    if "DAFS_TORCH_MP_RANK" in os.environ:
        raise SystemExit(child())
    raise SystemExit(parent())

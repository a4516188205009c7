"""Distributed range sort on the PyTorch port -- the paper's switch fabric
over ``torch.distributed``.  The twin of ``examples/distributed_sort.py``.

Ranks along one mesh axis play the switch's pipeline segments (one key
range each); the all_to_all is the fabric; each rank's local sort (K1's
presort on the card) is the segment pipeline; concatenating the ranks'
chunks in rank order is the server.  One process a rank
(``torch.multiprocessing.spawn``, a ``file://`` rendezvous in a temporary
directory): gloo on the CPU, NCCL with one card a rank.

    PYTHONPATH=src python examples/torch_distributed_sort.py [--ranks 8] [--device cuda|cpu]

The keys are the reference's, ``network_trace(8 * 131072)`` as int32
(``--n`` changes the count), so at 8 ranks every printed count equals the
reference's run on 8 devices.
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bootstrap  # noqa: F401,E402


def _rank(rank: int, world: int, rdv: str, args) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import gather_sorted, make_splitters, sort_sharded
    from repro_torch.core.runs import RunStats
    from repro_torch.data import network_trace
    from repro_torch.distributed.compat import make_mesh

    dev = torch.device("cuda", rank) if args.device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"file://{rdv}",
                            rank=rank, world_size=world, device_id=dev if dev.type == "cuda" else None)
    try:
        mesh = make_mesh((world,), ("segments",), dev.type)
        x = network_trace(args.n).astype(np.int32)
        if rank == 0:
            print(f"sorting {x.size} values across {world} devices "
                  f"({RunStats.of(torch.from_numpy(x)).num_runs} runs in input)", flush=True)
        # control plane: balanced splitters from a sample (the paper computes
        # ranges at the server because the data plane cannot divide)
        splitters = make_splitters(x[::97], world)
        n_loc = x.size // world
        x_loc = torch.from_numpy(x[rank * n_loc:(rank + 1) * n_loc]).to(dev)

        dist.barrier()
        t0 = time.perf_counter()
        padded, valid, overflow = sort_sharded(x_loc, mesh, "segments", splitters,
                                               capacity_factor=2.0, presort_block=256)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        dt = time.perf_counter() - t0
        parts = [torch.empty_like(padded) for _ in range(world)]
        dist.all_gather(parts, padded)
        counts = [torch.empty_like(valid) for _ in range(world)]
        dist.all_gather(counts, valid)
        drops = overflow.clone()
        dist.all_reduce(drops)
        if rank == 0:
            assert int(drops) == 0, "splitter imbalance"
            valid_all = torch.cat(counts).cpu()
            out = gather_sorted(torch.stack(parts).cpu(), valid_all)
            np.testing.assert_array_equal(out.numpy(), np.sort(x[: n_loc * world]))
            print(f"device counts: {valid_all.tolist()}")
            print(f"sorted + verified in {dt:.3f}s "
                  f"({RunStats.of(out).num_runs} run == fully sorted)", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--n", type=int, default=8 * 131_072)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"{args.ranks} ranks need {args.ranks} cards, found {torch.cuda.device_count()}")
    if args.device not in ("cuda", "cpu"):
        raise SystemExit(f"--device {args.device!r}: cuda or cpu")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(args.ranks, f"{tmp}/rendezvous", args), nprocs=args.ranks, join=True)


if __name__ == "__main__":
    main()

"""The dry run against a real step: a smoke dense and a smoke MoE train step
on 4 gloo ranks with SP (``_torch_dist_workers.dry_rank``), at (data 2, model
2) and at (pod 2, data 2, model 1) -- FSDP over the flattened (pod, data)
group, as on the 512-rank mesh -- count the same collectives (kind, count,
bytes), the same flops and the same kernel calls as
:func:`repro_torch.launch.dryrun.lower_cell` of the same cell at a 4-rank
fake world on the meta device."""

import math

import pytest

import _torch_threads  # noqa: F401  (one intra-op thread a worker)
from _torch_dist_workers import DRY, dry_costs, dry_rank, spawn_ranks

WORLD = 4
assert all(math.prod(dims) == WORLD for dims, _ in DRY["meshes"].values())


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    """Every rank's counts from the real step, and the dry run's."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    ranks = spawn_ranks(dry_rank, tmp_path_factory.mktemp("dry"), WORLD)
    dry = {}
    with dryrun.fake_world(WORLD):
        for name, (dims, axes) in DRY["meshes"].items():
            mesh = make_mesh(dims, axes, "cpu")
            for arch in DRY["archs"]:
                r = dryrun.lower_cell(arch, "train", mesh, verbose=False, cfg=configs.get_smoke_config(arch),
                                      spec=dict(seq=DRY["seq"], batch=DRY["batch"], kind="train"))
                dry.update(dry_costs({"flops": r["flops_per_device"], "per_collective": r["per_collective"],
                                      "kernels": r["kernels"]}, f"{name}/{arch}"))
                dry[f"{name}/{arch}/microbatches"] = r["microbatches"]
    return ranks, dry


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("arch", DRY["archs"])
@pytest.mark.parametrize("mesh", list(DRY["meshes"]))
def test_dry_run_counts_what_a_real_step_runs(counts, mesh, arch, rank):
    ranks, dry = counts
    prefix = f"{mesh}/{arch}/"
    real = {k: v for k, v in ranks[rank].items() if k.startswith(prefix)}
    mine = {k: v for k, v in dry.items() if k.startswith(prefix)}
    assert sorted(real) == sorted(mine)
    # the step runs collectives: FSDP's over (data) or the flattened (pod, data), and at tp 2 SP's
    assert mine[prefix + "coll/all-gather/count"] > 0 and mine[prefix + "coll/reduce-scatter/count"] > 0
    for k in mine:
        assert float(real[k]) == float(mine[k]), k

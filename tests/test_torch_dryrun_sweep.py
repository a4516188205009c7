"""The dry run's smoke sweep: every (arch, shape) cell, each arch's smoke
config (:func:`card_config`) at ``SMOKE_SHAPES``, traced by
:func:`repro_torch.launch.dryrun.lower_cell` on an 8-rank fake world at
(data 2, model 4) and (pod 2, data 2, model 2), ends ``ok``, or
``skipped`` by the reference's rule; a smoke config whose head dim the
card's kernels do not take is refused as the card refuses it; and each
family's per-rank
bytes of parameters, AdamW's moments, the batch and the cache equal the
reference's: its ``eval_shape`` shapes cut by ``model.specs()``,
``opt_state_specs``, ``batch_specs`` and ``cache_specs`` over an
``AbstractMesh`` of the same shape (a dimension its axes do not divide
padded up, as XLA lays it out), but for the leaves the port lays out
otherwise by design (:func:`deliberate_bytes`), held to their own closed
form."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)
from test_torch_dryrun import ARCHS, SHAPES, ref_dryrun

#: Each arch's smoke config at these shapes, on a (data 2, model 4) or (pod
#: 2, data 2, model 2) mesh of 8 ranks: the production cells, in seconds.
SMOKE_SHAPES = {
    "train_4k": dict(seq=64, batch=8, kind="train"),
    "prefill_32k": dict(seq=64, batch=4, kind="prefill"),
    "decode_32k": dict(seq=64, batch=8, kind="decode"),
    "long_500k": dict(seq=256, batch=1, kind="decode"),
}
SMOKE_MESHES = {"single_pod": ((2, 4), ("data", "model")), "multi_pod": ((2, 2, 2), ("pod", "data", "model"))}
MESHES = list(SMOKE_MESHES)
#: One arch of each family.
FAMILIES = {"dense": "mistral-nemo-12b", "moe": "granite-moe-3b-a800m", "hybrid": "zamba2-1.2b",
            "rwkv6": "rwkv6-1.6b", "encdec": "whisper-small", "embeds": "llava-next-34b"}


#: Smoke configs whose head dim (16) no kernel is built for.
REFUSED_HEAD_DIM = ["command-r-plus-104b", "llava-next-34b"]


def card_head_dim(cfg) -> dict:
    """``head_dim=32`` where the card's attention kernels take no head dim
    of ``cfg``'s (the smoke configs of :data:`REFUSED_HEAD_DIM`), else
    nothing; the same replacement serves the reference's config."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    return {} if cfg.resolved_head_dim in HEAD_DIMS[getattr(torch, cfg.dtype)] else {"head_dim": 32}


def card_config(arch: str):
    """``arch``'s smoke config at a head dim the card takes."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, **card_head_dim(cfg))


@pytest.fixture(scope="module")
def sweep():
    """(mesh, arch, shape) -> the cell's result dict."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    out = {}
    for mesh, (dims, axes) in SMOKE_MESHES.items():
        with dryrun.fake_world(math.prod(dims)):
            m = make_mesh(dims, axes, "cpu")
            for arch in ARCHS:
                for shape in SHAPES:
                    try:
                        r = dryrun.lower_cell(arch, shape, m, verbose=False, cfg=card_config(arch),
                                              spec=SMOKE_SHAPES[shape])
                    except Exception as e:  # noqa: BLE001 (recorded, as the CLI records it)
                        r = {"status": "error", "error": repr(e)}
                    out[mesh, arch, shape] = r
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_every_smoke_cell_traces(sweep, mesh, arch, shape):
    r = sweep[mesh, arch, shape]
    if shape == "long_500k" and arch not in ref_dryrun().LONG_OK:
        assert r["status"] == "skipped", r
        return
    assert r["status"] == "ok", r.get("error")
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["memory"]["temp_bytes"] > 0
    assert r["mesh"] == ({"data": 2, "model": 4} if mesh == "single_pod" else {"pod": 2, "data": 2, "model": 2})
    if r["kind"] == "train":
        # the port's collectives: FSDP gathers and reduce-scatters at least
        assert r["per_collective"]["all-gather"]["count"] > 0
        assert r["per_collective"]["reduce-scatter"]["count"] > 0


@pytest.mark.parametrize("arch", REFUSED_HEAD_DIM)
def test_a_head_dim_the_card_refuses_is_refused(arch):
    """The smoke config as it is: its head dim is one no kernel is built
    for, and the dry run refuses the cell as the card would."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    cfg = get_smoke_config(arch)
    assert card_head_dim(cfg)
    dims, axes = SMOKE_MESHES["single_pod"]
    with dryrun.fake_world(math.prod(dims)):
        mesh = make_mesh(dims, axes, "cpu")
        with pytest.raises(ValueError, match="head dims"):
            dryrun.lower_cell(arch, "train_4k", mesh, verbose=False, cfg=cfg, spec=SMOKE_SHAPES["train_4k"])


def _device_bytes(shape, dtype, spec, mesh_shape: dict) -> int:
    """One device's bytes of a leaf of ``shape`` laid out by ``spec``."""
    import jax.numpy as jnp

    n = 1
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        n *= -(-dim // math.prod(mesh_shape[a] for a in axes))
    return n * jnp.dtype(dtype).itemsize


def _leaf_bytes(tree, specs, mesh_shape: dict, dtype=None) -> dict:
    """Leaf name (its last key) -> one device's bytes, summed over the
    leaves of that name; ``dtype`` in place of each leaf's own."""
    import jax
    from jax.sharding import PartitionSpec as P

    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(flat) == len(spec_leaves)
    out: dict = {}
    for (path, x), spec in zip(flat, spec_leaves):
        name = str(getattr(path[-1], "key", path[-1]))
        out[name] = out.get(name, 0) + _device_bytes(x.shape, dtype or x.dtype, spec, mesh_shape)
    return out


def deliberate_bytes(cfg, leaf: str, tp: int, rows: int) -> int | None:
    """One rank's bytes of a leaf the port lays out otherwise than the
    reference, by design (ROADMAP §3, the recurrent kinds on a mesh), else
    None: where tp does not divide RWKV6's heads a rank holds every head
    (``bonus``, the ``wkv`` state; the reference pads the heads' cut), and
    the Mamba2 ``conv`` cache holds the rank's x channels and B/C groups
    (the reference holds every channel)."""
    if cfg.rwkv is not None:
        N = cfg.rwkv.head_size
        H = cfg.d_model // N
        if H % tp and leaf == "bonus":
            return cfg.num_layers * H * N * 4
        if H % tp and leaf == "wkv":
            return cfg.num_layers * rows * H * N * N * 4
    if cfg.ssm is not None and leaf == "conv":
        s = cfg.ssm
        groups = s.num_groups // tp if s.num_groups % tp == 0 else s.num_groups
        channels = s.expand * cfg.d_model // tp + 2 * groups * s.state_dim
        return cfg.num_layers * rows * (s.conv_width - 1) * channels * np.dtype(cfg.dtype).itemsize
    return None


def _total(leaves: dict, cfg, tp: int, rows: int = 0) -> int:
    return sum(b if (d := deliberate_bytes(cfg, name, tp, rows)) is None else d for name, b in leaves.items())


def reference_bytes(arch: str, mesh: str, shape: str) -> dict:
    """The reference's per-device bytes of the cell's arguments."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, PartitionSpec as P

    from repro import models
    from repro.configs import get_smoke_config
    from repro.data.synthetic import input_specs
    from repro.train.optimizer import opt_state_specs

    rd = ref_dryrun()
    dims, axes = SMOKE_MESHES[mesh]
    amesh = AbstractMesh(dims, axes)
    ms = dict(zip(axes, dims))
    s = SMOKE_SHAPES[shape]
    from repro_torch.configs import get_smoke_config as port_smoke_config

    cfg = dataclasses.replace(get_smoke_config(arch), **card_head_dim(port_smoke_config(arch)))
    ctx = rd.build_ctx(amesh, s["batch"], s["seq"], s["kind"])
    model = models.build(cfg, ctx)
    aparams = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    pspecs = model.specs()
    tp, rows = ms["model"], s["batch"] // math.prod(ms[a] for a in ctx.dp)
    out = {"params": _total(_leaf_bytes(aparams, pspecs, ms), cfg, tp)}
    if s["kind"] == "train":
        ospecs = opt_state_specs(pspecs)
        for moment in ("m", "v"):  # float32 moments
            out[moment] = _total(_leaf_bytes(aparams, ospecs[moment], ms, jnp.float32), cfg, tp)
        out["step"] = _device_bytes((), jnp.int32, ospecs["step"], ms)
        out["batch"] = _total(_leaf_bytes(input_specs(cfg, s["batch"], s["seq"]),
                                          rd.batch_specs(cfg, ctx, s["batch"], s["seq"]), ms), cfg, tp)
    else:
        kw = {"enc_len": s["seq"]} if cfg.is_encdec else {}
        acache = jax.eval_shape(lambda: model.init_cache(s["batch"], s["seq"], **kw))
        out["cache"] = _total(_leaf_bytes(acache, model.cache_specs(), ms), cfg, tp, rows)
        out["batch"] = _device_bytes((s["batch"],), jnp.int32, P(ctx.dp_axis), ms)
    return out


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("mesh", MESHES)
def test_per_rank_bytes_equal_the_references(sweep, mesh, family, shape):
    arch = FAMILIES[family]
    r = sweep[mesh, arch, shape]
    assert r["status"] == "ok", r.get("error")
    ref = reference_bytes(arch, mesh, shape)
    got = r["memory"]["arguments"]
    assert got["params"] == ref["params"]
    assert got["batch"] == ref["batch"]
    if shape == "train_4k":
        assert got["opt_state"] == ref["m"] + ref["v"] + ref["step"]
        assert r["memory"]["argument_bytes"] == got["params"] + got["opt_state"] + got["batch"]
    else:
        assert got["cache"] == ref["cache"]
    assert np.isfinite(r["flops_per_device"])

"""The port's partition rules (`repro_torch.sharding`) against the
reference's (`repro.sharding`), in one process.

The reference's spec functions read only a mesh's axis names and sizes,
so they run on `jax.sharding.AbstractMesh` here, and the port's on a
`DeviceGrid` of the same shape over meta devices. For the ten SMOKE
configs, on grids (2, 4) ("data", "model"), (1, 8) and (2, 2, 2) ("pod",
"data", "model"), with FSDP on and off, `param_specs` equals the
reference's leaf for leaf, exactly; so do `batch_specs`, `cache_specs`
and `adafactor_state_specs`. Then the chatglm3-6b divisibility checks of
`tests/test_sharding_subprocess.py:31-61`, the map onto the port's
parameter layout (`port_layout`), the placements, and the production
grids.
"""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config as r_full
from repro.configs import get_smoke_config as r_smoke
from repro.models import model as r_model
from repro.models import transformer as rt
from repro.sharding import rules as r_rules

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.leaves import leaf_groups
from repro_torch.models.model import abstract_params, input_specs, SHAPES
from repro_torch.sharding import (P, adafactor_state_specs, batch_specs,
                                  cache_specs, param_specs, port_layout,
                                  to_placements, with_divisibility)
from repro_torch.train.optim import AdafactorState

GRIDS = {"2x4": ((2, 4), ("data", "model")),
         "1x8": ((1, 8), ("data", "model")),
         "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def meshes(name):
    shape, names = GRIDS[name]
    return (AbstractMesh(shape, names),
            make_mesh(shape, names, ["meta"] * int(np.prod(shape))))


def flat(tree):
    """{dotted path: PartitionSpec} of a reference spec tree."""
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_spec)[0]}


def assert_specs_equal(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    bad = {k: (tuple(got[k]), tuple(want[k])) for k in want
           if tuple(got[k]) != tuple(want[k])}
    assert not bad, (what, bad)


@functools.lru_cache(maxsize=None)
def ref_abstract(arch):
    return r_model.abstract_params(r_smoke(arch))


@functools.lru_cache(maxsize=None)
def port_abstract(arch):
    return abstract_params(get_smoke_config(arch))


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, grid, fsdp):
    am, dm = meshes(grid)
    want = flat(r_rules.param_specs(ref_abstract(arch), r_smoke(arch), am,
                                    fsdp=fsdp))
    got = param_specs(port_abstract(arch), get_smoke_config(arch), dm,
                      fsdp=fsdp)
    assert_specs_equal(got, want, f"{arch} {grid}")


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_cache_and_adafactor_specs_match_the_reference(arch, grid):
    am, dm = meshes(grid)
    rcfg, cfg = r_smoke(arch), get_smoke_config(arch)
    # inputs: a batch that divides every DP extent, and one that does not
    for B in (8, 3):
        for shape in ("train_4k", "prefill_32k"):
            rb = r_model.input_specs(rcfg, r_model.SHAPES[shape],
                                     batch_override=B)
            pb = input_specs(cfg, SHAPES[shape], batch_override=B)
            assert_specs_equal(batch_specs(pb, dm),
                               flat(r_rules.batch_specs(rb, am)),
                               f"batch {shape} B={B}")
    # decode caches (S=16 divides the model extents; 2 and 3 batch rows)
    for B, S in ((2, 16), (3, 12)):
        rc = jax.eval_shape(lambda: rt.init_cache(rcfg, B, S))
        pc = tfm.init_cache(cfg, B, S, device="meta")
        assert_specs_equal(cache_specs(pc, cfg, dm),
                           flat(r_rules.cache_specs(rc, rcfg, am)),
                           f"cache B={B} S={S}")
    # Adafactor's factored moments, with FSDP
    rp = ref_abstract(arch)
    rps = r_rules.param_specs(rp, rcfg, am, fsdp=True)
    raopt = r_model.abstract_opt_state(rp, "adafactor")
    want = r_rules.adafactor_state_specs(raopt, rps, rp, am)
    model = port_abstract(arch)
    groups = leaf_groups(cfg, {n: tuple(p.shape)
                               for n, p in model.named_parameters()})
    got = adafactor_state_specs(AdafactorState(0, {}, {}),
                                param_specs(model, cfg, dm, fsdp=True),
                                {k: g.shape for k, g in groups.items()}, dm)
    assert tuple(got.step) == tuple(want.step) == ()
    assert_specs_equal(got.vr, flat(want.vr), "adafactor vr")
    assert_specs_equal(got.vc, flat(want.vc), "adafactor vc")


def test_chatglm_divisibility():
    """tests/test_sharding_subprocess.py:31-61 on the port: every spec
    divides its dimension; 2 KV heads on a 4-way model axis stay
    replicated, 8 query heads are sharded over it — decided on the head
    count, in the reference's layout and in the port's."""
    _, dm = meshes("2x4")
    cfg = get_smoke_config("chatglm3_6b")         # kv=2 < model=4
    model = port_abstract("chatglm3_6b")
    groups = leaf_groups(cfg, {n: tuple(p.shape)
                               for n, p in model.named_parameters()})
    specs = param_specs(model, cfg, dm, fsdp=True)
    for key, spec in specs.items():
        for dim, ax in zip(groups[key].shape, tuple(spec)):
            if ax is not None:
                n = dm.shape[ax] if isinstance(ax, str) else \
                    int(np.prod([dm.shape[a] for a in ax]))
                assert dim % n == 0, (key, spec, groups[key].shape)
    kv = [s for k, s in specs.items() if k.endswith("attn.wk")][0]
    assert "model" not in tuple(kv), kv
    q = [s for k, s in specs.items() if k.endswith("attn.wq")][0]
    assert "model" in tuple(q), q
    # the port's (d, Hkv*hd) = (64, 16) divides 4, yet stays replicated
    by_name, _ = port_layout(model, cfg, dm, fsdp=True)
    assert tuple(by_name["layers.0.attn.wk"]) == ("data", None)
    assert tuple(by_name["layers.0.attn.wq"]) == ("data", "model")
    assert tuple(by_name["layers.0.attn.wo"]) == ("model", "data")


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_layout_maps_the_reference_specs(arch, grid):
    """Each port parameter's spec is its reference leaf's with the stacked
    axis gone and merged dims taking their leading dim's axis; the leaf
    specs the port holds equal `param_specs` but where a merge hides a
    shard (sLSTM's wx when its heads divide the model axis)."""
    _, dm = meshes(grid)
    cfg, model = get_smoke_config(arch), port_abstract(arch)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    groups = leaf_groups(cfg, shapes)
    ref = param_specs(model, cfg, dm, fsdp=True)
    by_name, by_leaf = port_layout(model, cfg, dm, fsdp=True)
    assert set(by_name) == set(shapes) and set(by_leaf) == set(ref)
    for key, leaf in groups.items():
        if tuple(by_leaf[key]) != tuple(ref[key]):
            assert key.endswith("cell.wx"), (key, by_leaf[key], ref[key])
            assert "model" in tuple(ref[key])
            assert "model" not in tuple(by_leaf[key])
        for name, _ in leaf.members:
            spec = tuple(by_name[name])
            assert len(spec) == len(shapes[name]), name
            body = tuple(by_leaf[key])[1 if leaf.stacked else 0:]
            used = [a for a in body if a is not None]
            assert [a for a in spec if a is not None] == used, name
            for dim, ax in zip(shapes[name], spec):      # divisible
                if ax is not None:
                    assert dim % dm.shape[ax] == 0, (name, spec)


def test_to_placements_and_divisibility():
    from torch.distributed.tensor import Replicate, Shard
    _, dm = meshes("2x2x2")
    assert to_placements(P(("pod", "data"), None, "model"), dm) == (
        Shard(0), Shard(0), Shard(2))
    assert to_placements(P(), dm) == (Replicate(),) * 3
    assert to_placements(P(None, "data"), dm) == (Replicate(), Shard(1),
                                                   Replicate())
    assert tuple(with_divisibility(P("model", ("pod", "data")), (5, 8),
                                   dm)) == (None, ("pod", "data"))
    assert tuple(with_divisibility(P("model"), (4, 5), dm)) == ("model",
                                                                  None)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_specs_match_the_reference(multi_pod):
    """`make_production_mesh` is the reference's 16x16 (and 2x16x16) grid
    over meta devices; the published configs' specs on it equal the
    reference's on an AbstractMesh of that shape."""
    grid = make_production_mesh(multi_pod=multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert grid.axis_names == names and grid.size == int(np.prod(shape))
    assert {d.type for d in grid.devices.flat} == {"meta"}
    am = AbstractMesh(shape, names)
    for arch in ("llama3_2_1b", "deepseek_moe_16b"):
        want = flat(r_rules.param_specs(
            r_model.abstract_params(r_full(arch)), r_full(arch), am,
            fsdp=True))
        got = param_specs(abstract_params(get_config(arch)),
                          get_config(arch), grid, fsdp=True)
        assert_specs_equal(got, want, f"{arch} production")

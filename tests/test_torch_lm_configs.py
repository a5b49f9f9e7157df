"""The port's LM architecture registry against the reference's: for all ten
architectures, the published `CONFIG` and the reduced `SMOKE` equal the
reference's field by field, and the derived quantities (`layer_kinds`,
`is_enc_dec`, `q_per_kv`, `param_count`, `active_param_count`) are equal.
"""
import dataclasses

import pytest

import repro.configs as R

import repro_torch.configs as P
from repro_torch.models.config import ModelConfig


def test_registry_names_equal_the_reference():
    assert P.ARCH_IDS == R.ARCH_IDS
    assert P.ALIASES == R.ALIASES
    for alias, arch in R.ALIASES.items():
        assert P.canonical(alias) == R.canonical(alias) == arch
    assert P.canonical("llama3_2_1b") == "llama3_2_1b"
    assert [f.name for f in dataclasses.fields(ModelConfig)] == [
        f.name for f in dataclasses.fields(R.ModelConfig)]


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", R.ARCH_IDS)
def test_config_equals_the_reference_field_by_field(arch, which):
    get_p = P.get_config if which == "CONFIG" else P.get_smoke_config
    get_r = R.get_config if which == "CONFIG" else R.get_smoke_config
    for name in (arch, *[a for a, c in R.ALIASES.items() if c == arch]):
        p, r = get_p(name), get_r(name)
        assert isinstance(p, ModelConfig)
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert p.layer_kinds == r.layer_kinds
        assert (p.is_enc_dec, p.q_per_kv) == (r.is_enc_dec, r.q_per_kv)
        assert p.param_count() == r.param_count()
        assert p.active_param_count() == r.active_param_count()


def test_all_configs_and_derived_defaults():
    got = P.all_configs()
    assert list(got) == R.ARCH_IDS
    assert {a: dataclasses.asdict(c) for a, c in got.items()} == {
        a: dataclasses.asdict(c) for a, c in R.all_configs().items()}
    # head_dim 0 resolves to d_model // n_heads, as in the reference
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=32)
    assert cfg.head_dim == 16 and cfg.q_per_kv == 2

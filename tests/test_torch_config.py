"""The port's copies of the config dataclasses, option registries and
architecture configs equal the JAX package's, field by field and default by
default (exact equality: they are pure data)."""
import dataclasses

import jax  # noqa: F401  (both frameworks load in one test process)
import pytest
import torch  # noqa: F401

import repro.common.config as JC
import repro.configs as JCFG
import repro_torch.common.config as TC
import repro_torch.configs as TCFG

DATACLASSES = ["MoEOption", "MoEConfig", "SSMConfig", "RWKVConfig",
               "ModelConfig", "TrainConfig", "ServeConfig", "InputShape"]


def _fields(cls):
    return [(f.name, f.type, f.default,
             f.default_factory() if f.default_factory is not
             dataclasses.MISSING else None) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", DATACLASSES)
def test_dataclass_fields_and_defaults(name):
    assert _fields(getattr(TC, name)) == _fields(getattr(JC, name))


@pytest.mark.parametrize("registry", ["MOE_OPTIONS", "TRAIN_OPTIONS",
                                      "SERVE_OPTIONS", "INPUT_SHAPES",
                                      "MOE_DRYRUN_OPTS", "TRAIN_DRYRUN_OPTS"])
def test_registries_equal(registry):
    def plain(v):
        if dataclasses.is_dataclass(v):
            return dataclasses.asdict(v)
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if isinstance(v, tuple):
            return tuple(plain(x) for x in v)
        return v
    assert plain(getattr(TC, registry)) == plain(getattr(JC, registry))


@pytest.mark.parametrize("arch", list(JCFG._MODULES))
@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
def test_arch_configs_equal(arch, which):
    j = getattr(JCFG, which)(arch)
    t = getattr(TCFG, which)(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_registry_lists_equal():
    assert TCFG._MODULES == JCFG._MODULES
    assert TCFG.ASSIGNED == JCFG.ASSIGNED and TCFG.PAPER == JCFG.PAPER


@pytest.mark.parametrize("kw", [
    {"dispatch_backend": "dropless", "recv_bound_factor": 2.0},
    {"sort_impl": "radix"},
    {"router_impl": "fused", "tight_level2_capacity": True},
    {"wire_integrity": "detect", "dispatch_backend": "dropless"},
])
def test_with_options_accepts_like_reference(kw):
    assert (dataclasses.asdict(TC.MoEConfig().with_options(**kw))
            == dataclasses.asdict(JC.MoEConfig().with_options(**kw)))


@pytest.mark.parametrize("kw", [
    {"nope": 1}, {"dispatch_backend": "x"}, {"ragged_a2a": 1},
    {"recv_bound_factor": 2.0}, {"recv_bound_factor": True},
])
def test_with_options_rejects_like_reference(kw):
    with pytest.raises(ValueError):
        JC.MoEConfig().with_options(**kw)
    with pytest.raises(ValueError):
        TC.MoEConfig().with_options(**kw)


def test_fault_plan_rejected_until_ported():
    with pytest.raises(ValueError, match="not ported"):
        TC.MoEConfig().with_options(fault_plan="counts")
    assert TC.MoEConfig().with_options(fault_plan=None).fault_plan is None

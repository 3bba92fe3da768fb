"""The port's data pipeline against the JAX package's: ``make_batch`` and
``DataPipeline`` give the same arrays, bit for bit, for every batch layout
(the paper's MLM, a causal LM, MusicGen's delay-patterned codebooks and
phi-3-vision's image inputs)."""
import numpy as np
import pytest

from repro.configs import get_reduced as jget_reduced
from repro.data import pipeline as JP
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.data import pipeline as TP

ARCHS = ["smile-3.7b", "qwen3-moe-30b-a3b", "musicgen-large",
         "phi-3-vision-4.2b"]


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step", [0, 7])
def test_make_batch_matches_jax(arch, step):
    jcfg, tcfg = jget_reduced(arch), tget_reduced(arch)
    _equal(TP.make_batch(tcfg, 3, 40, seed=5, step=step),
           JP.make_batch(jcfg, 3, 40, seed=5, step=step))


def test_mlm_mask_matches_jax():
    toks = np.random.default_rng(0).integers(8, 500, (4, 64)).astype(np.int32)
    for prob in (0.15, 0.5):
        got = TP.mlm_mask(np.random.default_rng(1), toks, 500, prob)
        want = JP.mlm_mask(np.random.default_rng(1), toks, 500, prob)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    masked = got[1] != TP.IGNORE
    assert masked.any() and (got[0][masked] != toks[masked]).any()


def test_delay_pattern_matches_jax():
    toks = np.arange(2 * 4 * 9, dtype=np.int32).reshape(2, 4, 9)
    np.testing.assert_array_equal(TP._delay_pattern(toks),
                                  JP._delay_pattern(toks))


def test_data_pipeline_matches_jax():
    jcfg, tcfg = jget_reduced("smile-3.7b"), tget_reduced("smile-3.7b")
    tp = TP.DataPipeline(tcfg, 2, 32, seed=3)
    jp = JP.DataPipeline(jcfg, 2, 32, seed=3)
    try:
        for _ in range(4):
            _equal(next(tp), next(jp))
    finally:
        tp.close()
        jp.close()

"""The port's training data (``repro_torch.data.pipeline``) against the JAX
package's on the CPU: both are numpy, so every array must be equal, bit
for bit, for every seed and step."""
import numpy as np
import pytest

from repro.configs import ARCH_IDS, get_reduced as j_get_reduced
from repro.data import pipeline as jp

from repro_torch.configs import get_reduced
from repro_torch.data import pipeline as tp


def same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_synthetic_tokens_equal_the_reference(seed):
    t, j = tp.SyntheticTokens(100, 4, 8, seed), jp.SyntheticTokens(100, 4, 8, seed)
    for step in (0, 1, 7, 1000):
        same(t.batch_at(step), j.batch_at(step))
    assert not np.array_equal(t.batch_at(8)["tokens"], t.batch_at(7)["tokens"])


@pytest.mark.parametrize("seed,branch", [(0, 4), (5, 2), (9, 7)])
def test_markov_tokens_and_entropy_floor_equal_the_reference(seed, branch):
    t = tp.MarkovTokens(64, 8, 32, branch=branch, seed=seed)
    j = jp.MarkovTokens(64, 8, 32, branch=branch, seed=seed)
    np.testing.assert_array_equal(t.successors, j.successors)
    np.testing.assert_array_equal(t.probs, j.probs)
    assert t.entropy_floor() == j.entropy_floor()
    assert 0 < t.entropy_floor() < np.log(branch) + 1e-12
    for step in (0, 2, 49):
        same(t.batch_at(step), j.batch_at(step))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch_equals_the_reference_for_every_family(arch):
    for step, seed in ((0, 0), (3, 7)):
        got = tp.make_batch(get_reduced(arch), 2, 16, step, seed)
        same(got, jp.make_batch(j_get_reduced(arch), 2, 16, step, seed))
    cfg = get_reduced(arch)
    if cfg.family == "audio":
        assert got["frames"].shape == (2, cfg.enc_frames, cfg.d_model)
    if cfg.family == "vlm":
        assert got["vision_embeds"].shape == (2, cfg.n_vision_tokens, cfg.d_model)
        # arange on all three streams, as the reference draws them
        np.testing.assert_array_equal(got["positions"],
                                      np.broadcast_to(np.arange(16), (3, 2, 16)))

"""``kernel.dkdv_splits``: the CTAs of the attention gradient's dk/dv
cluster, a pure function of the shape and the card's SM count, pinned at
an H100's 132 SMs. The one-block grid (c = 1) wherever it is balanced
already (llama3.2-3b's, musicgen-medium's, grok-1's and nemotron-4's
training shapes), a split at qwen3-moe's 64/4 heads; and over a grid of
shapes, c divides the group, is at most 8, and is the smallest divisor
whose longest CTA is within 1.1x of the balanced share wherever one is."""

import pytest

from repro_torch.configs import get_arch
from repro_torch.kernels.attention import kernel as K

SMS = 132  # an H100 SXM's


def _shape(name):
    cfg = get_arch(name)
    return cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads


def _longest_and_share(b, s, kv, g, c):
    steps = K.dkdv_steps(s)
    return g // c * steps[0], b * kv * g * sum(steps) / SMS


def test_steps_count_the_first_key_block_and_the_total_at_qwen3_moes_shape():
    steps = K.dkdv_steps(4096)
    assert len(steps) == 32 and steps[0] == 64 and steps[-1] == 2
    assert 4 * 16 * sum(steps) == 67584  # 512 steps an SM over 132


@pytest.mark.parametrize("name", ["llama3.2-3b", "musicgen-medium", "grok-1-314b", "nemotron-4-340b",
                                  "minitron-4b", "internvl2-2b", "zamba2-2.7b"])
def test_balanced_training_shapes_keep_the_one_block_grid(name):
    kv, g = _shape(name)
    assert K.dkdv_splits(1, 4096, kv, g, SMS) == 1


def test_qwen3_moes_training_shape_splits_the_group():
    kv, g = _shape("qwen3-moe-235b-a22b")
    assert (kv, g) == (4, 16)
    c = K.dkdv_splits(1, 4096, kv, g, SMS)
    assert c == 2
    longest, share = _longest_and_share(1, 4096, kv, g, c)
    assert longest == 512 and share == 512.0


def test_starcoder2s_nine_head_group_splits_in_three():
    kv, g = _shape("starcoder2-7b")
    assert (kv, g) == (4, 9) and K.dkdv_splits(1, 4096, kv, g, SMS) == 3


@pytest.mark.parametrize("s", [1, 37, 64, 129, 1000, 2048, 4096, 8192])
@pytest.mark.parametrize("b,kv", [(1, 1), (1, 4), (2, 2), (1, 8), (4, 8)])
@pytest.mark.parametrize("g", [1, 2, 3, 6, 9, 12, 16, 24])
def test_splits_divide_the_group_and_balance_where_they_can(g, b, kv, s):
    c = K.dkdv_splits(b, s, kv, g, SMS)
    divisors = [d for d in range(1, min(g, K.DKDV_MAX_SPLITS) + 1) if g % d == 0]
    assert c in divisors
    meets = [d for d in divisors if _longest_and_share(b, s, kv, g, d)[0] <= K.DKDV_BALANCE
             * _longest_and_share(b, s, kv, g, d)[1]]
    assert c == (meets[0] if meets else divisors[-1])


def test_no_positions_take_no_split():
    assert K.dkdv_splits(1, 0, 4, 16, SMS) == 1

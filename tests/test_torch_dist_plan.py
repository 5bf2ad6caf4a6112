"""The distance kernel's launch plan (knn/score.py dist_plan, which
csrc/dist_tiles.cu checks) and the wrapper's bf16 path against the JAX
package's `dist_tiles`, on the CPU. The kernel itself runs only on the card
(tests/test_torch_gpu.py); here the wrapper takes its plain twin, which
upcasts bf16 queries exactly as the kernel does, so the bf16 path is the
f32 path on the upcast values, bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fedmse_tpu.knn.score import dist_tiles as jax_dist_tiles
from fedmse_tpu.ops.distance import pairwise_sq_dists as jax_pairwise
from fedmse_tpu_torch.knn import dist_tiles
from fedmse_tpu_torch.knn.score import (BLOCKS_PER_SM, MAX_GROUPS,
                                        MIN_GROUPS, STREAM_BYTES, dist_plan)

torch.set_num_threads(1)

H100_SMS = 132


# ------------------------------- dist_plan -------------------------------- #

@pytest.mark.parametrize("rows,bank,lat,sms,want", [
    # the main path: the evaluation and the two serving buckets
    (30_000, 512, 7, H100_SMS, (128, 396, True)),
    (256, 512, 7, H100_SMS, (128, 128, False)),
    (1024, 512, 7, H100_SMS, (128, 396, False)),
    # one warp per row pass at small banks: 8 rows a CTA at a time
    (1, 1, 7, H100_SMS, (32, 1, False)),
    (65, 3, 1, H100_SMS, (32, 9, False)),
    (100, 100, 16, H100_SMS, (32, 13, False)),
    (64, 128, 7, H100_SMS, (32, 8, False)),
    (64, 129, 7, H100_SMS, (64, 16, False)),
    # the whole CTA on one row from 1,024 slots on; wider banks take passes
    (5, 1024, 128, H100_SMS, (256, 5, False)),
    (5, 4096, 7, H100_SMS, (256, 5, False)),
    # CTAs capped at 3 per SM, whatever the card
    (10_000, 512, 7, 20, (128, 60, False)),
    # evict-first stores only past STREAM_BYTES of output
    (12_288, 1024, 7, H100_SMS, (256, 396, False)),
    (12_289, 1024, 7, H100_SMS, (256, 396, True)),
])
def test_dist_plan_rules(rows, bank, lat, sms, want):
    assert dist_plan(rows, bank, lat, sms) == want


@pytest.mark.parametrize("rows,bank,lat,sms", [
    (0, 512, 7, H100_SMS), (10, 0, 7, H100_SMS), (10, 512, 0, H100_SMS),
    (10, 512, 129, H100_SMS), (10, 512, 7, 0),
])
def test_dist_plan_refuses_what_the_kernel_does_not_take(rows, bank, lat,
                                                         sms):
    with pytest.raises(ValueError, match="no distance plan"):
        dist_plan(rows, bank, lat, sms)


@pytest.mark.parametrize("sms", [1, 16, 132])
def test_dist_plan_covers_every_row_and_slot(sms):
    """For every plan: the pass is a power of two of 4-slot groups between a
    warp and a CTA, covering the bank (or 1,024 slots a pass); the CTAs,
    at most 3 per SM, hold every row set of a pass at once where they can."""
    for rows in (1, 7, 8, 9, 63, 64, 65, 1000, 30_000):
        for bank in (1, 3, 4, 100, 128, 129, 512, 1000, 1024, 1025):
            groups, ctas, streaming = dist_plan(rows, bank, 7, sms)
            assert MIN_GROUPS <= groups <= MAX_GROUPS
            assert groups & (groups - 1) == 0
            assert 4 * groups >= min(bank, 4 * MAX_GROUPS)
            assert groups == MIN_GROUPS or 4 * groups // 2 < bank
            row_step = 8 // (groups // 32)
            assert 1 <= ctas <= min(rows, BLOCKS_PER_SM * sms)
            assert ctas == min(-(-rows // row_step), BLOCKS_PER_SM * sms)
            assert streaming == (4 * rows * bank > STREAM_BYTES)


# --------------------------- the bf16 wrapper ---------------------------- #

def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("lat", [1, 7, 16, 128])
def test_bf16_dist_tiles_match_jax_pallas_interpret_and_xla(lat):
    """bf16 queries through the wrapper equal the JAX package's dist_tiles
    on the same bf16 queries in interpret and xla mode, at 1e-5 scaled
    (summation order only), and equal the wrapper's own f32 path on the
    upcast values bit for bit."""
    rng = np.random.default_rng(lat)
    q = _bf16(rng.normal(size=(37, lat)).astype(np.float32) * 1.5)
    b = rng.normal(size=(128, lat)).astype(np.float32)
    got = dist_tiles(torch.from_numpy(q).to(torch.bfloat16),
                     torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32 and got.shape == (37, 128)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    for mode in ("xla", "interpret"):
        want = np.asarray(jax_dist_tiles(jq, jnp.asarray(b), mode=mode))
        assert _scaled_err(got, want) <= 1e-5, mode
    f32 = dist_tiles(torch.from_numpy(q), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), f32.view(np.int32))
    assert dist_tiles.launches == 0  # the CPU runs the plain twin


@pytest.mark.parametrize("kind", ["client_major", "random"])
def test_routed_bf16_dist_tiles_match_jax_per_bank(kind):
    """Routed bf16 rows, only some of the banks in use: each row against
    its own bank as the JAX package scores one bank, at 1e-5 scaled; a row
    permutation moves the rows and nothing else."""
    rng = np.random.default_rng(3)
    n, t, lat = 6, 50, 7
    banks = rng.normal(size=(n, 24, lat)).astype(np.float32)
    q = _bf16(rng.normal(size=(t, lat)).astype(np.float32))
    used = np.array([1, 4], np.int32)  # banks 0, 2, 3 and 5 stay unused
    gw = (np.repeat(used, -(-t // 2))[:t] if kind == "client_major"
          else rng.choice(used, t).astype(np.int32))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = dist_tiles(tq, torch.from_numpy(banks), torch.from_numpy(gw))
    want = np.stack([np.asarray(jax_pairwise(
        jnp.asarray(q[i:i + 1]).astype(jnp.bfloat16),
        jnp.asarray(banks[gw[i]])))[0] for i in range(t)])
    assert _scaled_err(got.numpy(), want) <= 1e-5
    perm = torch.from_numpy(rng.permutation(t))
    moved = dist_tiles(tq[perm], torch.from_numpy(banks),
                       torch.from_numpy(gw)[perm])
    assert torch.equal(moved.view(torch.int32), got[perm].view(torch.int32))

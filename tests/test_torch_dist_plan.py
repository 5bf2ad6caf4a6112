"""The distance kernel's and the one-pass kNN score's launch plans
(knn/score.py dist_plan and knn_plan, which csrc/dist_tiles.cu checks), the
wrapper's bf16 path against the JAX package's `dist_tiles`, and the kNN
score's CPU twin against the JAX package's scores, on the CPU. The kernels
themselves run only on the card (tests/test_torch_gpu.py); here the
wrappers take their plain twins, which upcast bf16 queries exactly as the
kernels do, so the bf16 path is the f32 path on the upcast values, bit for
bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fedmse_tpu.knn import ReferenceBank as JaxBank
from fedmse_tpu.knn import knn_kth_distance as jax_kth
from fedmse_tpu.knn import routed_kth_distance as jax_routed
from fedmse_tpu.knn.score import dist_tiles as jax_dist_tiles
from fedmse_tpu.ops.distance import pairwise_sq_dists as jax_pairwise
from fedmse_tpu_torch.knn import (ReferenceBank, dist_tiles, knn_kth_distance,
                                  knn_score, routed_kth_distance)
from fedmse_tpu_torch.knn.score import (BLOCKS_PER_SM, MAX_GROUPS, MAX_K,
                                        MIN_GROUPS, SCORE_BLOCKS_PER_SM,
                                        SCORE_WARPS, STAGE_SM_BYTES,
                                        STAGE_WARP_BYTES, STREAM_BYTES,
                                        dist_plan, knn_plan)
from tests.knn_jax_scores import ONE, PATH, jax_scores

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


# ------------------------------- knn_plan --------------------------------- #

@pytest.mark.parametrize("rows,bank,lat,k,sms,want", [
    # the hybrid cells' evaluations: 500 and 10 gateways, bank 512, L 7, k 8
    (1_500_000, 512, 7, 8, H100_SMS, (396, True)),
    (30_000, 512, 7, 8, H100_SMS, (396, True)),
    # serving buckets: a warp for every row
    (256, 512, 7, 8, H100_SMS, (64, True)),
    (1024, 512, 7, 8, H100_SMS, (256, True)),
    (1, 1, 1, 1, H100_SMS, (1, True)),
    (5, 16, 7, 32, H100_SMS, (2, True)),
    # the stage's size sets the CTAs an SM: 8 KB a warp (4), 24 KB (2),
    # 32 KB (1), and no stage past 32 KB or above L = 8 (4)
    (1_500_000, 256, 3, 8, H100_SMS, (528, True)),
    (1_500_000, 512, 8, 32, H100_SMS, (264, True)),
    (1_500_000, 1024, 7, 8, H100_SMS, (132, True)),
    (1_500_000, 1025, 7, 8, H100_SMS, (528, False)),
    (1_500_000, 512, 12, 8, H100_SMS, (528, False)),
    (10_000, 512, 128, 32, 20, (80, False)),
])
def test_knn_plan_rules(rows, bank, lat, k, sms, want):
    assert knn_plan(rows, bank, lat, k, sms) == want


@pytest.mark.parametrize("rows,bank,lat,k,sms", [
    (0, 512, 7, 8, H100_SMS), (10, 0, 7, 8, H100_SMS),
    (10, 512, 0, 8, H100_SMS), (10, 512, 129, 8, H100_SMS),
    (10, 512, 7, 0, H100_SMS), (10, 512, 7, MAX_K + 1, H100_SMS),
    (10, 512, 7, 8, 0),
])
def test_knn_plan_refuses_what_the_kernel_does_not_take(rows, bank, lat, k,
                                                        sms):
    with pytest.raises(ValueError, match="no kNN score plan"):
        knn_plan(rows, bank, lat, k, sms)


@pytest.mark.parametrize("sms", [1, 16, 132])
def test_knn_plan_is_one_wave_of_4_warp_ctas(sms):
    """Every plan: a warp for each row up to the CTAs an SM holds (4,
    or as many as STAGE_SM_BYTES holds of 4 warps' stages, at least 1),
    times the SMs; banks staged exactly when L <= 8 and a warp's stage,
    [B][8] f32 ([B][12] at L = 8), fits STAGE_WARP_BYTES."""
    for rows in (1, 31, 32, 127, 128, 129, 30_000, 1_500_000):
        for bank in (1, 16, 100, 512, 1024, 2048):
            for lat in (1, 3, 4, 7, 8, 9, 128):
                ctas, stage = knn_plan(rows, bank, lat, 8, sms)
                size = 4 * bank * (12 if lat == 8 else 8)
                assert stage == (lat <= 8 and size <= STAGE_WARP_BYTES)
                per_sm = SCORE_BLOCKS_PER_SM
                if stage:
                    per_sm = max(1, min(per_sm, STAGE_SM_BYTES
                                        // (SCORE_WARPS * size)))
                assert ctas == min(-(-rows // SCORE_WARPS), per_sm * sms)


# ------------------- the kNN score's CPU twin against JAX ------------------ #

@pytest.mark.parametrize("topk", ["exact", "approx"])
def test_cpu_knn_score_matches_jax_routed_and_one_bank(topk):
    """On CPU tensors routed_kth_distance and knn_kth_distance run the
    composition (knn_score's plain twin), as before the one-pass kernel:
    ragged counts (0, < k, = B) routed over 5 banks and one bank against
    the JAX package's scores at 1e-5 (summation order only), and
    knn_score itself is the same bits, with no kernel launch."""
    rng = np.random.default_rng(9)
    n, b, lat, t, k = 5, 64, 7, 120, 8
    latents = rng.normal(size=(n, b, lat)).astype(np.float32)
    count = np.array([64, 0, 3, 40, 8], np.int32)
    latents[np.arange(b)[None, :] >= count[:, None]] = 0.0
    q = rng.normal(size=(t, lat)).astype(np.float32)
    gw = rng.integers(0, n, t).astype(np.int32)
    bank = ReferenceBank(torch.from_numpy(latents), torch.from_numpy(count))
    tq, tgw = torch.from_numpy(q), torch.from_numpy(gw)
    before = knn_score.launches
    got = routed_kth_distance(tq, tgw, bank, k, topk=topk)
    want = np.asarray(jax_routed(jnp.asarray(q), jnp.asarray(gw),
                                 JaxBank(latents=jnp.asarray(latents),
                                         count=jnp.asarray(count)),
                                 k, topk=topk))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(knn_score(tq, bank.latents, tgw, bank.count, k, topk),
                       got)
    one = knn_kth_distance(tq, bank.latents[3], bank.count[3], k, topk=topk)
    want_one = np.asarray(jax_kth(jnp.asarray(q), jnp.asarray(latents[3]),
                                  int(count[3]), k, topk=topk))
    np.testing.assert_allclose(one.numpy(), want_one, rtol=1e-5, atol=1e-6)
    assert knn_score.launches == before  # the CPU runs the composition


JAX_SCORES = np.load(PATH)


@pytest.mark.parametrize("topk", ["exact", "approx"])
@pytest.mark.parametrize("case", range(3))
def test_stored_jax_knn_scores_are_the_jax_package_s(case, topk):
    """tests/data/knn_jax_scores.npz, which the card test holds the CUDA kNN
    score to, is the JAX package's output on its stored inputs (bit for
    bit), and the CPU twin matches it at 1e-5 scaled (summation order
    only; k = 1 at L = 3 finds near neighbours whose distances lose
    relative precision to the norms' cancellation)."""
    q, banks, count, gw = (JAX_SCORES[f"{n}{case}"]
                           for n in ("q", "banks", "count", "gw"))
    k = int(JAX_SCORES[f"k{case}"])
    assert int(JAX_SCORES["one_bank"]) == ONE
    routed, one = jax_scores(q, banks, count, gw, k, topk)
    want = JAX_SCORES[f"routed{case}_{topk}"]
    want_one = JAX_SCORES[f"one{case}_{topk}"]
    np.testing.assert_array_equal(routed, want)
    np.testing.assert_array_equal(one, want_one)
    bank = ReferenceBank(torch.from_numpy(banks), torch.from_numpy(count))
    got = routed_kth_distance(torch.from_numpy(q), torch.from_numpy(gw),
                              bank, k, topk=topk)
    assert _scaled_err(got.numpy(), want) <= 1e-5
    got_one = knn_kth_distance(torch.from_numpy(q), bank.latents[ONE],
                               bank.count[ONE], k, topk=topk)
    assert _scaled_err(got_one.numpy(), want_one) <= 1e-5

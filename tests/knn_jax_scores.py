"""Writes data/knn_jax_scores.npz: the JAX package's kNN scores on a few fixed
inputs, so that the one-pass CUDA kNN score, which runs where JAX does not,
is held to the JAX reference (tests/test_torch_gpu.py) on the same inputs.
tests/test_torch_dist_plan.py recomputes every score from the stored
inputs and checks the file still holds the JAX package's output.

    JAX_PLATFORMS=cpu python tests/knn_jax_scores.py

Each case is (B, L, k) of the card tests' grid, f32, over 6 banks with
counts B, 0, min(B, 5), B, B - 3 and 1 (empty, fewer than k, full and
ragged), 600 client-major rows: (512, 7, 8) is the main path's shape with
approximate top-k over 256 strided bins, (100, 12, 32) ragged bins with
streamed latents, (1024, 3, 1) 32 bins."""

import os
import sys

import numpy as np

CASES = ((512, 7, 8), (100, 12, 32), (1024, 3, 1))
ROWS, BANKS, ONE = 600, 6, 3   # ONE: the bank of the one-bank scores
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "knn_jax_scores.npz")


def case_inputs(b, lat, seed):
    """(q [T, L], banks [N, B, L], count [N], gw [T]) of one case."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((ROWS, lat)) * 1.5).astype(np.float32)
    banks = rng.standard_normal((BANKS, b, lat)).astype(np.float32)
    count = np.array([b, 0, min(b, 5), b, max(b - 3, 1), 1], np.int32)
    gw = np.repeat(np.arange(BANKS, dtype=np.int32), -(-ROWS // BANKS))
    return q, banks, count, gw[:ROWS]


def jax_scores(q, banks, count, gw, k, topk):
    """(routed scores [T], one-bank scores [T] against bank ONE) by the
    JAX package."""
    import jax.numpy as jnp
    from fedmse_tpu.knn import ReferenceBank, knn_kth_distance
    from fedmse_tpu.knn import routed_kth_distance
    routed = routed_kth_distance(
        jnp.asarray(q), jnp.asarray(gw),
        ReferenceBank(latents=jnp.asarray(banks), count=jnp.asarray(count)),
        k, topk=topk)
    one = knn_kth_distance(jnp.asarray(q), jnp.asarray(banks[ONE]),
                           int(count[ONE]), k, topk=topk)
    return np.asarray(routed), np.asarray(one)


def main():
    out = {"one_bank": np.int32(ONE)}
    for c, (b, lat, k) in enumerate(CASES):
        q, banks, count, gw = case_inputs(b, lat, seed=c)
        out.update({f"q{c}": q, f"banks{c}": banks, f"count{c}": count,
                    f"gw{c}": gw, f"k{c}": np.int32(k)})
        for topk in ("exact", "approx"):
            out[f"routed{c}_{topk}"], out[f"one{c}_{topk}"] = jax_scores(
                q, banks, count, gw, k, topk)
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH}: {len(CASES)} cases")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()

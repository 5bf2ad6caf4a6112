"""Latent-space k-nearest-neighbour anomaly scoring (port of
fedmse_tpu/knn/): each gateway scores a row by its latent's distance to the
k-th nearest neighbour in a bank of its own normal latents.

  bank.py   fixed-capacity per-gateway banks [N, B, L] + count [N]; the
            priority-trick downsample; the existing= refresh; npz
            persistence beside the checkpoint tree
  score.py  the score in one pass on the CUDA kernel knn_score of
            csrc/dist_tiles.cu (distances, count mask, exact or approximate
            top-k, one launch for all rows, each against its own bank), and
            the distance tiles alone (dist_tiles)

Wired into the evaluator (score_kind='knn'), every round's evaluation, the
serving engine (gather, dense and single-tenant), its hot swap and the
--serve pass of `python -m fedmse_tpu_torch.main`.
"""

from fedmse_tpu_torch.knn.bank import (ReferenceBank, bank_path, build_banks,
                                       downsample_latents, load_bank,
                                       pow2_bank_size, save_bank)
from fedmse_tpu_torch.knn.score import (dist_tiles, knn_kth_distance,
                                        knn_score, knn_smallest_k,
                                        routed_kth_distance)

__all__ = [
    "ReferenceBank",
    "bank_path",
    "build_banks",
    "dist_tiles",
    "downsample_latents",
    "knn_kth_distance",
    "knn_score",
    "knn_smallest_k",
    "load_bank",
    "pow2_bank_size",
    "routed_kth_distance",
    "save_bank",
]

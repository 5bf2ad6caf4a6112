"""Measured autotuner for launch-size knobs (port of fedmse_tpu/tune/).

  * `cache`   the backend+shape-keyed JSON tuning cache
              (TUNE_CACHE_TORCH.json at the repository root, read only if
              present; FEDMSE_TUNE_CACHE points elsewhere). A lookup needs
              an EXACT signature match; disk writes need FEDMSE_TUNE=1.
  * `measure` warm, min-over-k timing, each call waited for on the card.
  * `sites`   the call sites: `tune_*` measures and stores a winner,
              `lookup_*` is the read that serving/engine.py
              (bucket_ladder="auto") and federation/tiered.py
              (init_chunk=None) make; a miss keeps their defaults.

    from fedmse_tpu_torch.tune import sites
    sites.tune_serve_ladder(max_bucket=1024, dim=115)   # FEDMSE_TUNE=1
    sites.tune_tier_chunk()
"""

from fedmse_tpu_torch.tune import sites
from fedmse_tpu_torch.tune.cache import (DEFAULT_PATH, TuningCache,
                                         default_cache)
from fedmse_tpu_torch.tune.measure import best_wall, measure_candidates

__all__ = ["DEFAULT_PATH", "TuningCache", "default_cache", "best_wall",
           "measure_candidates", "sites"]

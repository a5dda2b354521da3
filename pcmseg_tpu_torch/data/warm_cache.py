"""Dataset-level preprocessing-cache warmer.

The port's copy of ``pcmseg_tpu/data/warm_cache.py``, over the port's own
dataset (``data/dataset.py``), whose ``.npz`` entries either package reads.

The reference decoded + resampled every case on every epoch
(script/data_loader.py:224-330 runs inside __getitem__); our dataset
caches the processed (image, label) stack as one .npz per case
(data/dataset.py). This tool populates that cache up front — threaded on
one host, and shardable across hosts (each process warms
``cases[process_index::process_count]``).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

from pcmseg_tpu_torch.core.config import Config
from pcmseg_tpu_torch.data.dataset import ProstateDataset
from pcmseg_tpu_torch.utils.logging import get_logger


def warm_cache(
    config: Config,
    num_threads: int = 4,
    process_index: int = 0,
    process_count: int = 1,
    verbose: bool = True,
) -> Dict[str, object]:
    """Decode+resample every case once so its .npz cache entry exists.

    Returns a summary dict: cases warmed / already cached / failed, and
    wall time. Idempotent — a second run only stat()s the cache files.
    """
    from pcmseg_tpu_torch.data.dataset import resolve_cache_dir

    if not resolve_cache_dir(config.cache_dir):
        # covers both cache_dir=None and 'auto' disabled via
        # PCMSEG_CACHE_DIR="" — otherwise the dataset resolves to no cache
        # and the os.path.join below dies with an opaque TypeError
        raise ValueError("warm_cache requires an enabled cache_dir")
    if not (0 <= process_index < process_count):
        raise ValueError(
            f"process_index {process_index} out of range for "
            f"process_count {process_count}"
        )
    log = get_logger("pcmseg.warm_cache")
    ds = ProstateDataset(
        data_dir=config.data_dir,
        data_type=config.data_type,
        modalities=config.modalities,
        target_size=config.target_size,
        missing_strategy=config.missing_strategy,
        normalize=config.normalize,
        norm_percentiles=config.norm_percentiles,
        cache_dir=config.cache_dir,
        n_classes=getattr(config, "n_classes", 1),
        coregister=getattr(config, "coregister", False),
    )
    indices = list(range(process_index, len(ds), process_count))
    t0 = time.perf_counter()
    warmed, cached, failed = [], [], []

    def one(i: int) -> None:
        rec = ds.case_list[i]
        cpath = os.path.join(ds.cache_dir, ds._cache_key(rec) + ".npz")
        if os.path.exists(cpath):
            cached.append(rec.case_id)
            return
        try:
            ds.load_case(i)
            warmed.append(rec.case_id)
        except Exception as e:  # keep warming the rest of the shard
            failed.append(rec.case_id)
            log.warning("cache warm failed for %s: %s", rec.case_id, e)

    with ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:
        list(pool.map(one, indices))

    summary = {
        "data_type": config.data_type,
        "cache_dir": ds.cache_dir,
        "process": f"{process_index}/{process_count}",
        "shard_cases": len(indices),
        "warmed": len(warmed),
        "already_cached": len(cached),
        "failed": len(failed),
        "failed_cases": failed,
        "seconds": round(time.perf_counter() - t0, 3),
    }
    if verbose:
        log.info(
            "warmed %d, already cached %d, failed %d (%.1fs, %d threads)",
            summary["warmed"],
            summary["already_cached"],
            summary["failed"],
            summary["seconds"],
            num_threads,
        )
    return summary

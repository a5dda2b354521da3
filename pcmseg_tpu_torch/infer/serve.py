"""Long-running segmentation server over a directory of cases, on the GPU.

The port of ``pcmseg_tpu/infer/serve.py``. The checkpoint is loaded once
and the Predictor stays resident:

  * ``run_once`` segments every unprocessed case directory under
    ``input_root`` and returns; ``run`` polls for new cases until stopped;
  * a case is any subdirectory holding at least one modality subdirectory;
    it is served once its files have been quiescent for ``min_age``
    seconds, so a case still being copied in is not zero-filled;
  * a case whose output exists is done (outputs are written atomically);
    a case that fails ``max_attempts`` times is quarantined;
  * the next case's host decode runs on a one-ahead thread while the
    current case runs on the device; with ``device_ingest`` that thread
    only decodes (``Predictor.read_case``) and the normalization, cast and
    stack run on the device from the serving thread (``Predictor.ingest``,
    ``serve.py:157-202``);
  * ``profile_dir``: a one-shot ``torch.profiler`` trace of the first
    ``profile_steps`` cases served, from case 0 (a server may only ever see
    one case), with the ``serve.*`` spans (``utils/profiling.py``) as its
    annotations; ``close()`` (the CLI calls it on every exit path, ``run``
    at its end) writes a window that is still open
    (``serve.py:69-78, 191-235``).

Fold ensembles, TTA, postprocessing, K-class heads (uint8 label maps of
class ids) and spatially sharded forwards (``spatial_parallel``) come with
the Predictor.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from pcmseg_tpu_torch.core.config import Config
from pcmseg_tpu_torch.utils.logging import get_logger
from pcmseg_tpu_torch.infer.predict import Predictor, _find_volume_file
from pcmseg_tpu_torch.utils.profiling import StepTraceController, span


class PredictionServer:
    """Resident Predictor + directory polling loop.

    ``stats`` counts done, distinct failed, quarantined ('skipped') and
    not-yet-quiescent ('waiting') cases; ``latencies`` holds each served
    case's wall seconds from the start of its processing to its written
    mask (host decode overlapped by the prefetch thread is not in it).
    """

    def __init__(
        self,
        config: Config,
        checkpoint_path: str,
        input_root: str,
        output_dir: str,
        output_name: str = "segmentation.nii.gz",
        explicit=(),
        min_age: float = 30.0,
        max_attempts: int = 3,
        device=None,
    ):
        self.input_root = input_root
        self.output_dir = output_dir
        self.output_name = output_name
        self.log = get_logger("pcmseg.serve")
        self.predictor = Predictor(config, checkpoint_path, explicit=explicit, device=device)
        # discovery uses the checkpoint's adopted config (its modalities)
        self.config = self.predictor.config
        self.min_age = min_age
        self.max_attempts = max_attempts
        self._attempts: Dict[str, int] = {}
        self.stats = {"done": 0, "failed": 0, "skipped": 0, "waiting": 0}
        self.latencies: Dict[str, float] = {}
        self._tracer = StepTraceController(
            config.profile_dir, self.predictor.device, start_step=0, n_steps=config.profile_steps
        )
        self._cases_seen = 0

    # -- discovery -------------------------------------------------------------

    def _is_case_dir(self, path: str) -> bool:
        return os.path.isdir(path) and any(
            _find_volume_file(os.path.join(path, m)) for m in self.config.modalities
        )

    def _is_ready(self, path: str) -> bool:
        """No file under the case dir changed in the last ``min_age``
        seconds, by the newer of mtime and ctime (copies that preserve
        mtimes still stamp ctime). ``min_age <= 0`` makes every case ready."""
        if self.min_age <= 0:
            return True
        newest = 0.0
        for base, _, files in os.walk(path):
            for f in files:
                try:
                    st = os.stat(os.path.join(base, f))
                except OSError:
                    continue
                newest = max(newest, st.st_mtime, st.st_ctime)
        return newest > 0 and (time.time() - newest) >= self.min_age

    def _output_path(self, case_id: str) -> str:
        return os.path.join(self.output_dir, case_id, self.output_name)

    def pending_cases(self) -> List[str]:
        """Unprocessed, ready case ids under input_root, sorted; sets
        ``stats['waiting']`` and ``stats['skipped']`` as a side effect."""
        if not os.path.isdir(self.input_root):
            return []
        out = []
        waiting = quarantined = 0
        for name in sorted(os.listdir(self.input_root)):
            case_dir = os.path.join(self.input_root, name)
            if not self._is_case_dir(case_dir) or os.path.exists(self._output_path(name)):
                continue
            if self._attempts.get(name, 0) >= self.max_attempts:
                quarantined += 1
                continue
            if not self._is_ready(case_dir):
                waiting += 1
                self.log.info(
                    "case %s not quiescent yet; waiting (min_age=%.0fs)", name, self.min_age
                )
                continue
            out.append(name)
        self.stats["waiting"] = waiting
        self.stats["skipped"] = quarantined
        return out

    # -- serving ---------------------------------------------------------------

    def _load(self, case_id: str):
        """The host half of one case's ingest (thread-safe, no device work):
        decode and normalize, or under ``device_ingest`` decode only."""
        with span("serve.decode", case_id):
            return self.predictor.read_case(os.path.join(self.input_root, case_id))

    def process_case(self, case_id: str, preloaded=None) -> Optional[str]:
        """Segment one case. ``preloaded`` may be a Future from ``_load``;
        its exception, if any, counts against this case only."""
        t0 = time.perf_counter()
        self._tracer.on_step(self._cases_seen)
        self._cases_seen += 1
        try:
            with span("serve.case", case_id):
                with span("serve.prefetch_wait"):
                    image, reference = preloaded.result() if preloaded is not None else self._load(case_id)
                with span("serve.dispatch"):
                    # under device_ingest: the raw channels -> the stack on the device
                    image = self.predictor.ingest(image)
                mask = self.predictor.predict_mask(image)
                with span("serve.write"):
                    out = self.predictor.save_mask(mask, reference, self._output_path(case_id))
        except Exception as e:  # one bad case must not stop the server
            first_failure = case_id not in self._attempts
            self._attempts[case_id] = self._attempts.get(case_id, 0) + 1
            if first_failure:
                self.stats["failed"] += 1
            if self._attempts[case_id] >= self.max_attempts:
                self.log.exception(
                    "case %s failed %d times; quarantined: %s", case_id, self._attempts[case_id], e
                )
            else:
                self.log.exception("case %s failed: %s", case_id, e)
            return None
        self._attempts.pop(case_id, None)
        self.stats["done"] += 1
        self.latencies[case_id] = time.perf_counter() - t0
        self.log.info("case %s → %s (%.2fs)", case_id, out, self.latencies[case_id])
        return out

    def close(self) -> None:
        """Write the profiler trace if its window is still open (a run
        shorter than the window). Idempotent."""
        self._tracer.close()

    def run_once(self) -> Dict[str, int]:
        """Segment every pending case once; returns the running stats."""
        with span("serve.poll"):
            cases = self.pending_cases()
        if not cases:
            return dict(self.stats)
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self._load, cases[0])
            for i, case_id in enumerate(cases):
                nxt = pool.submit(self._load, cases[i + 1]) if i + 1 < len(cases) else None
                self.process_case(case_id, preloaded=fut)
                fut = nxt
        return dict(self.stats)

    def run(
        self,
        poll_interval: float = 5.0,
        max_polls: Optional[int] = None,
        stop_file: Optional[str] = None,
    ) -> Dict[str, int]:
        """Watch input_root until ``stop_file`` appears, ``max_polls``
        rounds have run, or the process is interrupted."""
        polls = 0
        self.log.info(
            "serving %s → %s (poll %.1fs)", self.input_root, self.output_dir, poll_interval
        )
        while True:
            self.run_once()
            polls += 1
            if stop_file and os.path.exists(stop_file):
                self.log.info("stop file %s present; exiting", stop_file)
                break
            if max_polls is not None and polls >= max_polls:
                break
            try:
                with span("serve.poll"):
                    time.sleep(poll_interval)
            except KeyboardInterrupt:
                self.log.info("interrupted; exiting")
                break
        self.close()
        return dict(self.stats)

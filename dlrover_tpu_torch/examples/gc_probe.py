"""The Llama worker under a garbage-collection log: where CPython's
collections land beside the steps.

Runs ``llama_train.main`` (of the ``dlrover_tpu_torch`` on the path) in
this process with a ``gc.callbacks`` hook that appends one line per
collection of an older generation, or of the youngest that took over
2 ms, to ``--gc-log``: its Unix end time, generation, milliseconds and
objects collected. The other arguments go to the worker; its
``--log-file`` holds the step lines with their Unix times, so each
collection falls between two of them. On the card:

    python -m dlrover_tpu_torch.run --standalone \\
        dlrover_tpu_torch/examples/gc_probe.py --gc-log /tmp/gc.log \\
        --config llama_1b --steps 5 --report-interval 1 \\
        --ckpt-dir /tmp/ckpt --save-interval 100 --log-file /tmp/w.log
"""

from __future__ import annotations

import argparse
import gc
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--gc-log", required=True)
    args, rest = parser.parse_known_args(argv)
    started = [0.0]

    def on_gc(phase: str, info: dict) -> None:
        if phase == "start":
            started[0] = time.perf_counter()
            return
        ms = (time.perf_counter() - started[0]) * 1e3
        if info["generation"] > 0 or ms > 2.0:
            with open(args.gc_log, "a") as f:
                f.write(f"{time.time():.6f} gen={info['generation']} "
                        f"ms={ms:.2f} collected={info['collected']}\n")

    gc.callbacks.append(on_gc)
    from dlrover_tpu_torch.examples import llama_train

    return llama_train.main(rest)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the wall time of ``chip_smoke.py``'s host-heavy phases goes, by
sampling the main thread's Python stack every 10 ms.

    python3 scripts/smoke_phase_sample.py [phase ...]

Builds the kernels as ``chip_smoke.py`` does, then runs each named phase
of ``PHASES`` (default: serve, serve-xlstm, baselines, fed and async)
once with a sampler thread beside it. For each phase
it prints the phase's seconds and writes ``results/sample_<phase>.txt``:
the seconds spent inside each function (inclusive, the 120 largest) and
at the top of the stack (the 30 largest), each the phase's seconds times
the function's share of the samples. Needs one CUDA device.
"""
import collections
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PHASES = {
    "serve": lambda: cs.phase_serve(),
    "serve-xlstm": lambda: cs.phase_serve(arch=cs.XLSTM, phase="serve-xlstm",
                                          layers=cs.XLSTM_SERVE_LAYERS),
    "baselines": lambda: cs.phase_baselines(),
    "fed": lambda: cs.phase_fed(),
    "async": lambda: cs.phase_async(),
    "resume": lambda: cs.phase_resume(),
    "faults": lambda: cs.phase_faults(),
    "dispatch": lambda: cs.phase_dispatch(),
    "serve-moe": lambda: cs.phase_serve(arch=cs.MOE, phase="serve-moe",
                                        layers=cs.MOE_SERVE_LAYERS),
    "train-check": lambda: cs.phase_train_check(),
    "train-check-xlstm": lambda: cs.phase_xlstm_train_check(),
    "check-moe-train": lambda: cs.phase_moe_train_check(),
}
DEFAULT = ("serve", "serve-xlstm", "baselines", "fed", "async")


def sampled(label, fn, period=0.01):
    main = threading.get_ident()
    inclusive, top = collections.Counter(), collections.Counter()
    stop, count = threading.Event(), [0]

    def sample():
        while not stop.is_set():
            frame, seen, first = sys._current_frames().get(main), set(), True
            while frame is not None:
                code = frame.f_code
                key = (f"{os.path.basename(code.co_filename)}:"
                       f"{code.co_name}:{code.co_firstlineno}")
                if first:
                    top[key] += 1
                    first = False
                if key not in seen:
                    inclusive[key] += 1
                    seen.add(key)
                frame = frame.f_back
            count[0] += 1
            time.sleep(period)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    t0 = time.perf_counter()
    fn()
    seconds = time.perf_counter() - t0
    stop.set()
    thread.join()
    n = max(count[0], 1)
    with open(os.path.join("results", f"sample_{label}.txt"), "w") as f:
        f.write(f"{label}: {seconds:.1f} s, {n} samples\n-- inclusive\n")
        for key, c in inclusive.most_common(120):
            f.write(f"{c / n * seconds:8.1f} s  {key}\n")
        f.write("-- top of the stack\n")
        for key, c in top.most_common(30):
            f.write(f"{c / n * seconds:8.1f} s  {key}\n")
    print(f"[sample] {label}: {seconds:.1f} s", flush=True)


def main():
    names = sys.argv[1:] or list(DEFAULT)
    unknown = set(names) - set(PHASES)
    if unknown:
        sys.exit(f"unknown phases {sorted(unknown)}; choose from {list(PHASES)}")
    if not torch.cuda.is_available():
        sys.exit("smoke_phase_sample: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs("results", exist_ok=True)
    cs.phase_device()
    cs.phase_build()
    for name in names:
        sampled(name, PHASES[name])


if __name__ == "__main__":
    main()

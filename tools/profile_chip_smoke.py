#!/usr/bin/env python3
"""Where ``chip_smoke.py`` spends its wall time, by a stack sampler.

    python3 tools/profile_chip_smoke.py [--period 0.1] [--out FILE]

Runs ``chip_smoke.main()`` in this process (on the card, as the script
itself runs) while a thread samples the main thread's stack every
``--period`` seconds. It prints the inclusive seconds of each call path
of ``chip_smoke`` functions (up to six deep) and writes them, with the
innermost ``repro_torch`` function and innermost frame of each sample,
to ``--out`` (default ``chiprun_out/chip_smoke_profile.json``). A
sample is taken when the main thread lets the sampler run, which it does
inside every PyTorch call, so host waits on the card are attributed to
the Python line that waits. Exits with ``chip_smoke``'s code.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tag(code) -> str:
    """A frame's label: ``cs:`` for chip_smoke, ``rt:`` for the port."""
    fn = code.co_filename
    if fn.endswith("chip_smoke.py"):
        return "cs:" + code.co_name
    if "repro_torch/" in fn:
        return "rt:" + fn.split("repro_torch/")[-1] + ":" + code.co_name
    return "x:" + fn.rsplit("/", 1)[-1] + ":" + code.co_name


def summarize(samples: list, period: float) -> dict:
    """Inclusive seconds by chip_smoke call path, and sample counts by
    innermost port function and innermost frame."""
    incl = collections.Counter()
    leaf_rt = collections.Counter()
    leaf_any = collections.Counter()
    for stack in samples:
        cs = [t for t in stack if t.startswith("cs:")]
        for i in range(1, min(len(cs), 6) + 1):
            incl[" > ".join(cs[:i])] += 1
        where = cs[-1] if cs else ""
        rts = [t for t in stack if t.startswith("rt:")]
        if rts:
            leaf_rt[f"{where} | {rts[-1]}"] += 1
        if stack:
            leaf_any[f"{where} | {stack[-1]}"] += 1
    return {"period": period, "samples": len(samples),
            "incl": {k: v * period for k, v in incl.most_common()},
            "leaf_rt": {k: v * period for k, v in leaf_rt.most_common(300)},
            "leaf_any": {k: v * period
                         for k, v in leaf_any.most_common(300)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--period", type=float, default=0.1)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "chip_smoke_profile.json"))
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    main_id = threading.main_thread().ident
    samples: list = []
    stop = threading.Event()

    def sample() -> None:
        while not stop.is_set():
            frame = sys._current_frames().get(main_id)
            stack = []
            while frame is not None:
                stack.append(_tag(frame.f_code))
                frame = frame.f_back
            samples.append(stack[::-1])
            time.sleep(args.period)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        rc = chip_smoke.main()
    finally:
        stop.set()
        sampler.join()
    out = summarize(samples, args.period)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"profile: {out['samples']} samples every {args.period} s; "
          f"inclusive seconds by call path (written to {path}):")
    for key, sec in list(out["incl"].items())[:60]:
        print(f"  {sec:8.1f} {key}")
    return rc


if __name__ == "__main__":
    sys.exit(main())

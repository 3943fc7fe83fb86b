"""Dry run of every (arch × shape × mesh) cell on the meta device.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles each cell against ``ShapeDtypeStruct`` inputs on 512 forced
host devices and records XLA's memory and cost analyses. Here each cell
is built by :func:`repro_torch.launch.steps.build_cell` from meta tensors
and run once on the meta device inside the cost counter
(``launch.cost_analysis``); no card and no memory are needed. Per cell it
records:

* ``arch``, ``shape``, ``mesh``, ``meta``, ``loss``, ``fsdp``, ``tag``;
* ``analyze_s``, the seconds of the build and the meta run (in place of
  ``lower_s`` / ``compile_s``; the CLI runs a step once and records that
  run on both meshes, since the step runs unpartitioned and its count does
  not depend on the mesh: the second mesh's seconds are its build's);
* ``memory``, per device under the cell's specs:
  ``argument_size_in_bytes`` (parameters, train state, batch or caches),
  ``output_size_in_bytes``, and ``temp_size_in_bytes``, the counter's
  ``peak_bytes``: the peak of the tensors the step allocated, over the
  whole unpartitioned step (the cell's mesh is a mesh by shape);
* ``analysis``: the counter's output, for the whole step. Its
  ``collective_*`` entries are None: the cell runs on one meta device,
  unpartitioned. The sharded step runs on a placed mesh
  (``distributed.placement``), whose gathers and reduce-scatters
  ``chip_smoke.py`` phase 25 counts on the card;
* ``status``.

Artifacts go to ``dryrun_out/<arch>__<shape>__<mesh>.json`` at the
repository root.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--loss kd|ce]
        [--skip-existing] [--tag T]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (ARCH_NAMES, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell, device_bytes

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "dryrun_out")


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single",
             loss: str = "kd", fsdp: bool = True, rules_override=None,
             accum_steps: int = 4, tag: str = "", tcfg_overrides=None,
             arch_overrides=None, mesh=None, dtype=torch.bfloat16) -> dict:
    """Build and run one cell on the meta device; its record. ``mesh``
    (any ``launch.mesh.Mesh``) replaces the production mesh
    ``mesh_kind`` names."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.time()
    plan = build_cell(arch, shape_name, mesh, loss=loss, fsdp=fsdp,
                      rules_override=rules_override, accum_steps=accum_steps,
                      tcfg_overrides=tcfg_overrides,
                      arch_overrides=arch_overrides, dtype=dtype)
    return record(plan, plan.analyze(), arch, shape_name, mesh_kind, loss,
                  fsdp, tag, t0)


def record(plan, run: tuple, arch: str, shape_name: str, mesh_kind: str,
           loss: str, fsdp: bool, tag: str, t0: float) -> dict:
    """The record of a built cell ``plan`` from a meta run of its step,
    ``run = (analysis, outputs)`` (``plan.analyze()``, or that of the same
    step built on another mesh), begun at ``t0``."""
    analysis, out = run
    analysis = dict(analysis)
    t1 = time.time()
    for k in ("collective_bytes", "collective_counts",
              "collective_total_bytes"):
        analysis[k] = None
    with shd.activate(plan.mesh, plan.rules):
        out_specs = plan.out_specs(out)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "meta": plan.meta, "loss": loss, "fsdp": fsdp, "tag": tag,
        "analyze_s": round(t1 - t0, 2),
        "memory": {
            "argument_size_in_bytes": device_bytes(plan.args, plan.arg_specs,
                                                   plan.mesh),
            "output_size_in_bytes": device_bytes(out, out_specs, plan.mesh),
            "temp_size_in_bytes": analysis["peak_bytes"]},
        "analysis": analysis,
        "status": "ok",
    }


def cell_path(arch, shape, mesh_kind, tag=""):
    """Artifact path of one cell."""
    sfx = f"__{tag}" if tag else ""
    return os.path.join(ART_DIR, f"{arch}__{shape}__{mesh_kind}{sfx}.json")


def main(argv=None) -> int:
    """CLI entry point (see the module docstring)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--loss", default="kd", choices=["kd", "ce"])
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    os.makedirs(ART_DIR, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            if args.shape and shape_name != args.shape:
                continue
            if not shape_applicable(cfg, shape):
                print(f"[dryrun] SKIP {arch} x {shape_name} "
                      f"(long-context needs sub-quadratic mixer)")
                continue
            run = None              # the step's meta run, for both meshes
            for mesh_kind in meshes:
                path = cell_path(arch, shape_name, mesh_kind, args.tag)
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] cached {arch} x {shape_name} x "
                          f"{mesh_kind}")
                    continue
                print(f"[dryrun] {arch} x {shape_name} x {mesh_kind} ...",
                      flush=True)
                try:
                    t0 = time.time()
                    plan = build_cell(arch, shape_name, make_production_mesh(
                        multi_pod=(mesh_kind == "multi")), loss=args.loss)
                    if run is None:
                        run = plan.analyze()
                    rec = record(plan, run, arch, shape_name, mesh_kind,
                                 args.loss, True, args.tag, t0)
                    mem = rec["memory"]
                    print(f"    analyze {rec['analyze_s']}s  "
                          f"flops={rec['analysis']['flops']:.3e}  "
                          f"hbm={rec['analysis']['hbm_bytes']:.3e}B  "
                          f"args/dev="
                          f"{mem['argument_size_in_bytes'] / 2**30:.2f}GiB  "
                          f"temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB",
                          flush=True)
                except Exception as e:  # noqa: BLE001 (recorded per cell)
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failures.append((arch, shape_name, mesh_kind, str(e)))
                    print(f"    FAILED: {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)

    print(f"\n[dryrun] done; {len(failures)} failures")
    for f in failures:
        print("  FAIL:", *f[:3], "--", f[3][:200])
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Per-card bytes of fp32 HWA distillation under ZeRO, from the port's dry run.

For phi-3-mini-4k at full width and one jamba-v0.1-52b super-block (8 of
its 32 layers), the ``train_4k`` cell (``launch.steps.build_cell``, KD
with the teacher inside) is built on the meta device in fp32 on host
meshes of 1, 2, 4 and 8 cards (``("data", n)``, ``("model", 1)``), as
``launch.dryrun.run_cell`` builds it. The parameters and the Adam moments
take ``zero_spec_tree``'s specs (fsdp), so each card holds ``1/n`` of
every leaf whose first free dimension ``n`` divides. Per card the table
gives the student, the teacher, the gradients (ZeRO-2: the moments'
specs), the two moments, their sum, and the cell's argument bytes as the
dry run records them (``argument_size_in_bytes``: student, teacher,
moments and the batch). The activations are not in it: the step runs
unpartitioned on the meta device, and its peak is the whole global
batch's; no step is run here.

    PYTHONPATH=src python tools/zero_plan_torch.py
"""

from __future__ import annotations

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_cell, device_bytes

PLANS = (("phi-3-mini-4k", None),
         ("jamba-v0.1-52b", {"num_layers": 8}))
CARDS = (1, 2, 4, 8)


def _gb(n: int) -> str:
    return f"{n / 1e9:.2f}"


def main() -> None:
    """Print the markdown table of ROADMAP section 1, item 10."""
    print("| config | cards | student | teacher | gradients | moments "
          "| state per card (GB) | dry-run arguments per card (GB) |")
    print("|---|---|---|---|---|---|---|---|")
    for arch, over in PLANS:
        for n in CARDS:
            mesh = make_host_mesh(1, devices=n)
            plan = build_cell(arch, "train_4k", mesh, dtype=torch.float32,
                              arch_overrides=over)
            params, state = plan.args[0], plan.args[1]
            student = device_bytes(params, plan.arg_specs[0], mesh)
            teacher = device_bytes(plan.args[4], plan.arg_specs[4], mesh)
            moments = device_bytes(state["opt"], plan.arg_specs[1]["opt"],
                                   mesh)
            with shd.activate(mesh, plan.rules):
                grads = device_bytes(params, shd.zero_spec_tree(params),
                                     mesh)
            args = device_bytes(plan.args, plan.arg_specs, mesh)
            name = arch if over is None else f"{arch} ({over['num_layers']} layers)"
            print(f"| {name} | {n} | {_gb(student)} | {_gb(teacher)} "
                  f"| {_gb(grads)} | {_gb(moments)} "
                  f"| {_gb(student + teacher + grads + moments)} "
                  f"| {_gb(args)} |")


if __name__ == "__main__":
    main()

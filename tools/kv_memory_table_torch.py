"""The KV-cache memory table of ``docs/serving.md``, from the PyTorch port.

The counterpart of ``tools/kv_memory_table.py``, with the same columns,
options and output, and no JAX: the parameter bytes come from the port's
meta-device build (``repro_torch.models.transformer.init_model(...,
device="meta")``, which allocates nothing) and its serve rules
(``distributed.sharding.param_spec_tree`` under ``serve_rules``, the
column-parallel ``_SERVE_PARAM_RULES``), the recurrent-state bytes from
``init_caches`` on the meta device.

Columns (per request slot, attention KV over ``--max-len`` tokens):
contiguous fp32 and bf16, paged int8 with its scales and block-table rows,
the bytes a cached ``--header`` costs once and the effective int8 bytes
when ``--share`` requests share it. ``--tp N`` prints the per-device table
instead: weights and per-slot KV + state divided over ``N`` shards where
they split, and whether each big config fits ``--budget-gib`` per device.

    PYTHONPATH=src python tools/kv_memory_table_torch.py [--max-len 4096]
        [--header 64] [--share 8] [--tp 4]
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config

ARCHS = ["phi-3-mini-4k", "llama-3.2-1b", "granite-3-8b", "jamba-v0.1-52b"]

#: big configs the ``--tp`` table proves fit per device under sharding
TP_ARCHS = ["dbrx-132b", "jamba-v0.1-52b", "qwen2.5-32b"]


def attn_layers(cfg) -> int:
    """Attention layers in the stack (hybrid: one per super-block)."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return 0 if cfg.is_attention_free else cfg.num_layers


def bytes_per_slot(cfg, max_len: int, block: int = 16):
    """(contiguous fp32, contiguous bf16, paged int8) bytes per slot."""
    la, kv, hd = attn_layers(cfg), cfg.num_kv_heads, cfg.head_dim
    fp32 = 2 * la * max_len * kv * hd * 4
    bf16 = fp32 // 2
    nb = -(-max_len // block)
    # two int32 table rows now: the read table + the write table
    int8 = 2 * la * nb * block * kv * (hd + 4) + 2 * la * nb * 4
    return fp32, bf16, int8


def cached_header_bytes(cfg, header: int, block: int = 16) -> int:
    """Paged-int8 bytes one cached shared header occupies (the one-time
    cost the prefix cache pays to make every sharer's prefill free)."""
    la, kv, hd = attn_layers(cfg), cfg.num_kv_heads, cfg.head_dim
    nb = -(-header // block)
    return 2 * la * nb * block * kv * (hd + 4)


def effective_bytes_per_slot(cfg, max_len: int, header: int, share: int,
                             block: int = 16) -> int:
    """Effective paged-int8 bytes per slot when ``share`` concurrent
    requests reference one cached ``header``-token prefix: the header is
    stored once, so each slot amortizes ``(share - 1) / share`` of it."""
    _, _, int8 = bytes_per_slot(cfg, max_len, block)
    hdr = cached_header_bytes(cfg, header, block)
    return int8 - hdr * (share - 1) // share


def _fmt(n: int) -> str:
    """Human MiB with 1 decimal."""
    return f"{n / 2**20:.1f}"


def _gib(n: int) -> str:
    """Human GiB with 1 decimal."""
    return f"{n / 2**30:.1f}"


def weight_bytes(cfg, tp: int, wbits: int = 32):
    """(total, per-device) parameter bytes under ``tp``-way serving.

    ``wbits`` prices the sharded kernel leaves (the analog matmul sites
    and the LM head) at that storage width (4 for the packed-int4 serve
    path); replicated leaves (norms, biases, the embedding table) stay
    fp32. Every leaf's shape comes from the meta build, and the serve
    table decides which leaves shard on the "model" axis."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T

    params, _ = T.init_model(None, cfg, torch.float32, torch.device("meta"))
    mesh = Mesh(("data", "model"), (1, tp))
    with sharding.activate(mesh, sharding.serve_rules(mesh)):
        specs = sharding.param_spec_tree(params)
    total = 0
    per_dev = 0

    def add(p, spec):
        nonlocal total, per_dev
        sharded = "model" in spec
        numel = p.numel()
        nbytes = (numel * wbits // 8 if sharded
                  else numel * p.element_size())
        total += nbytes
        per_dev += nbytes // (tp if sharded else 1)

    def walk(node, spec):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, spec[k])
            else:
                add(v, spec[k])

    walk(params, specs)
    return total, per_dev


def ssm_state_bytes(cfg) -> int:
    """Recurrent-state (SSD state + conv tail) bytes per slot, summed over
    the mamba layers of ``init_caches`` on the meta device: the part of a
    hybrid or SSM slot the attention-KV columns miss."""
    import torch

    from repro_torch.models import transformer as T

    caches = T.init_caches(cfg, 1, 16, device=torch.device("meta"))

    def walk(node, under: bool) -> int:
        total = 0
        for k, v in node.items():
            hit = under or k in ("ssm", "conv")
            if isinstance(v, dict):
                total += walk(v, hit)
            elif hit and isinstance(v, torch.Tensor):
                total += v.numel() * v.element_size()
        return total

    return walk(caches, False)


def tp_table(args) -> None:
    """Print the tensor-parallel bytes-per-device markdown table
    (``docs/distributed.md``): weights, per-slot KV + recurrent state,
    and whether each big config fits ``--budget-gib`` per device at tp=1
    vs ``--tp`` (kv_heads and ssm_heads shard; the block table and the
    host-side allocator stay replicated and cost nothing per shard)."""
    tp = args.tp
    wb = args.weight_bits
    print(f"| arch | params W{wb} | weights/dev tp=1 | tp={tp} "
          f"| KV+state /slot/dev tp=1 (MiB) | tp={tp} "
          f"| total/dev @{args.slots} slots tp=1 | tp={tp} "
          f"| fits {args.budget_gib:.0f} GiB |")
    print("|---|---|---|---|---|---|---|---|---|")
    for name in TP_ARCHS:
        cfg = get_config(name)
        total, wdev = weight_bytes(cfg, tp, wb)
        _, _, int8 = bytes_per_slot(cfg, args.max_len, args.block)
        ssm = ssm_state_bytes(cfg)
        kv = getattr(cfg, "num_kv_heads", 0) or 1
        kv_dev = int8 // tp if kv % tp == 0 else int8
        ssm_dev = ssm // tp if (not ssm or cfg.ssm_heads % tp == 0) else ssm
        slot1, slotn = int8 + ssm, kv_dev + ssm_dev
        tot1 = total + args.slots * slot1
        totn = wdev + args.slots * slotn
        budget = int(args.budget_gib * 2**30)
        fits = (f"{'yes' if tot1 <= budget else 'no'} → "
                f"{'yes' if totn <= budget else 'no'}")
        print(f"| {cfg.name} | {_gib(total)} | {_gib(total)} | {_gib(wdev)} "
              f"| {_fmt(slot1)} | {_fmt(slotn)} "
              f"| {_gib(tot1)} | {_gib(totn)} | {fits} |")


def main() -> None:
    """Print the markdown table docs/serving.md embeds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-len", type=int, default=4096)
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--header", type=int, default=64,
                    help="shared-prefix header length for the "
                         "cached-bytes / effective-capacity columns")
    ap.add_argument("--share", type=int, default=8,
                    help="requests sharing one cached header (the "
                         "best-of-n fan-out)")
    ap.add_argument("--tp", type=int, default=0,
                    help="print the tensor-parallel bytes-per-device "
                         "table for this shard count instead of the "
                         "per-slot table (docs/distributed.md)")
    ap.add_argument("--slots", type=int, default=8,
                    help="concurrent request slots in the --tp "
                         "total-per-device column")
    ap.add_argument("--budget-gib", type=float, default=80.0,
                    help="per-device memory budget the --tp fits "
                         "column checks against")
    ap.add_argument("--weight-bits", type=int, default=32,
                    help="storage bits for sharded kernel leaves in the "
                         "--tp table (4 = packed-int4 serve path)")
    args = ap.parse_args()
    if args.tp > 1:
        tp_table(args)
        return
    print(f"| arch | attn layers | KV x hd | contiguous fp32 (MiB/slot) "
          f"| bf16 | paged int8 | reduction "
          f"| hdr{args.header} cached (MiB) "
          f"| int8 @{args.share}-way hdr | eff. reduction |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for name in ARCHS:
        cfg = get_config(name)
        f32, b16, i8 = bytes_per_slot(cfg, args.max_len, args.block)
        hdr = cached_header_bytes(cfg, args.header, args.block)
        eff = effective_bytes_per_slot(cfg, args.max_len, args.header,
                                       args.share, args.block)
        print(f"| {cfg.name} | {attn_layers(cfg)} "
              f"| {cfg.num_kv_heads}x{cfg.head_dim} | {_fmt(f32)} "
              f"| {_fmt(b16)} | {_fmt(i8)} | {f32 / i8:.1f}x "
              f"| {_fmt(hdr)} | {_fmt(eff)} | {f32 / eff:.1f}x |")


if __name__ == "__main__":
    main()

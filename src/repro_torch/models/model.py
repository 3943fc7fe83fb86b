"""Public model API: ``build`` / ``apply`` / ``input_specs``, and
:class:`AnalogLM`, an ``nn.Module`` that holds the parameter tree as
buffers."""

from __future__ import annotations

import torch

from repro_torch.checkpoint import flatten_paths, unflatten_paths
from repro_torch.configs import ArchConfig, ShapeConfig, get_config
from repro_torch.core.analog import AnalogConfig, AnalogCtx
from repro_torch.models import transformer as T


def default_device() -> torch.device:
    """The card. Entry points run there unless the caller names another
    device; without one they raise instead of running on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def build(arch: str | ArchConfig, generator: torch.Generator | int = 0,
          dtype=torch.float32, device=None):
    """Initialize a model with random weights. Returns
    ``(cfg, params, labels)``. ``generator`` is a ``torch.Generator`` on
    ``device`` or an int seed; ``device`` defaults to the card."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    device = torch.device(device) if device is not None else default_device()
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    params, labels = T.init_model(generator, cfg, dtype, device)
    return cfg, params, labels


def apply(params, cfg: ArchConfig, acfg: AnalogConfig, ctx: AnalogCtx,
          inputs, **kw):
    """Run the model forward (alias of ``transformer.forward``)."""
    return T.forward(params, cfg, acfg, ctx, inputs, **kw)


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> dict:
    """The model's inputs for one (arch × shape) cell as meta tensors
    (the reference's ``ShapeDtypeStruct`` stand-ins; nothing is
    allocated).

    ``train``: tokens and labels [B, S] int32 (audio [B, S, K]); the vlm's
    text is ``S - vit_tokens`` long beside ``patch_embeds`` [B,
    vit_tokens, vit_dim] of ``dtype``. ``prefill``: the tokens (and
    ``patch_embeds``). ``decode``: one token, the contiguous cache of
    ``seq_len`` from :func:`transformer.init_caches` on the meta device,
    and ``pos``, the new token's position as the contiguous cache takes it
    (a host int, the cache's last)."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def ids(*dims):
        if cfg.family == "audio":
            dims += (cfg.num_codebooks,)
        return torch.empty(dims, dtype=torch.int32, device=meta)

    if shape.kind in ("train", "prefill"):
        text = s - cfg.vit_tokens if cfg.family == "vlm" else s
        specs = {"tokens": ids(b, text)}
        if shape.kind == "train":
            specs["labels"] = ids(b, text)
        if cfg.family == "vlm":
            specs["patch_embeds"] = torch.empty(
                (b, cfg.vit_tokens, cfg.vit_dim), dtype=dtype, device=meta)
        return specs
    caches = T.init_caches(cfg, b, s, dtype, device=meta)
    return {"token": ids(b, 1), "caches": caches, "pos": s - 1}


class AnalogLM(torch.nn.Module):
    """The parameter tree as buffers of nested submodules named by the
    reference's paths (``blocks/attn/qkv/kernel`` becomes the state-dict key
    ``blocks.attn.qkv.kernel``), so ``.to(device)`` and ``state_dict()``
    work. Its forward calls :func:`repro_torch.models.transformer.forward`."""

    def __init__(self, cfg: ArchConfig, params: dict,
                 acfg: AnalogConfig | None = None):
        super().__init__()
        self.cfg = cfg
        self.acfg = acfg or AnalogConfig()
        self._paths = list(flatten_paths(params))
        for path, leaf in flatten_paths(params).items():
            *parents, name = path.split("/")
            mod = self
            for p in parents:
                if p not in mod._modules:
                    mod.add_module(p, torch.nn.Module())
                mod = getattr(mod, p)
            mod.register_buffer(name, leaf)

    def params(self) -> dict:
        """The current buffers as the nested parameter dict."""
        return unflatten_paths({p: self.get_buffer(p.replace("/", "."))
                                for p in self._paths})

    def forward(self, tokens: torch.Tensor, caches: dict | None = None,
                pos_offset: int | None = None, last_only: bool = False):
        """Logits for ``tokens`` [B, S] (see ``transformer.forward``)."""
        logits, _, new_caches = T.forward(
            self.params(), self.cfg, self.acfg, AnalogCtx(),
            {"tokens": tokens}, caches=caches, pos_offset=pos_offset,
            last_only=last_only)
        return logits, new_caches

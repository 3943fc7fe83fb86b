"""The port's dense model against the reference on reduced configs.

Weights are built by the reference from a JAX key and carried across as
numpy through ``params_from_numpy`` (the port keeps the reference's
parameter layout, so this is a rename). Deployment noise is drawn once by
the reference and applied on both sides. Then:

* ``forward`` logits match at ``rtol = atol = 1e-5`` (the reference's own
  bar for fused vs unfused forwards) for ``off``, ``analog`` with injected
  hw noise, ``rtn`` and the packed-int4 deployment, with ``use_pallas`` off
  and on (on the CPU "on" runs the kernels' plain versions);
* prefill + decode equals the full forward within 5e-4, the reference's
  bar in ``tests/test_decode.py``;
* greedy ``generate`` emits the same tokens as the reference's;
* a checkpoint written by ``repro.checkpoint.save`` loads to identical
  arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_config
from repro.core import analog as ref_analog
from repro.models import apply as ref_apply
from repro.models import build as ref_build
from repro.serve import decode as ref_decode
from repro_torch.checkpoint import (flatten_paths, load_reference_npz,
                                    params_from_numpy, unflatten_paths)
from repro_torch.core import analog as port_analog
from repro_torch.models import AnalogLM
from repro_torch.models import apply as port_apply
from repro_torch.models import transformer as T
from repro_torch.serve import decode as port_decode

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["llama-3.2-1b", "phi-3-mini-4k"]
REF_EVAL = ref_analog.AnalogCtx(key=None, training=False)
PORT_EVAL = port_analog.AnalogCtx()


def _ref_flat(tree) -> dict:
    """Reference pytree → ``{"/"-joined path: numpy array}``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(cfg, reference params, labels and hw noise instance, and the port's
    params and noise instance)."""
    cfg = get_config(request.param).reduce()
    key = jax.random.PRNGKey(0)
    cfg, params, labels = ref_build(cfg, key)
    inst = ref_analog.sample_noise_instances(params, labels,
                                             jax.random.PRNGKey(1), "hw")
    port_params = params_from_numpy(_ref_flat(params), "cpu")
    port_inst = params_from_numpy(_ref_flat(inst), "cpu")
    return cfg, params, labels, inst, port_params, port_inst


def _deploy(carried, deploy):
    """Reference (params, acfg) and port (params, acfg) for one deployment.
    The reference's digital_int4 counterpart is its unfused RTN path, which
    its own suite holds equal to the packed-int4 kernel."""
    cfg, params, labels, inst, pp, pinst = carried
    plabels = T.model_labels(pp, cfg)
    if deploy == "off":
        return (params, ref_analog.AnalogConfig(mode="off"), pp,
                port_analog.AnalogConfig(mode="off"))
    if deploy == "analog_hw":
        rp = ref_analog.apply_noise_instances(params, labels, inst, "hw")
        tp = port_analog.apply_noise_instances(pp, plabels, pinst, "hw")
        return (rp, ref_analog.AnalogConfig(mode="analog", train_noise=False),
                tp, port_analog.AnalogConfig(mode="analog",
                                             train_noise=False))
    if deploy == "rtn":
        return (params, ref_analog.AnalogConfig(mode="rtn"), pp,
                port_analog.AnalogConfig(mode="rtn"))
    assert deploy == "digital_int4"
    return (params, ref_analog.AnalogConfig(mode="rtn", weight_bits=4),
            port_analog.pack_int4_weights(pp, plabels),
            port_decode.digital_int4_config(
                port_analog.AnalogConfig(weight_bits=4)))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_carry_over_is_a_rename(carried):
    cfg, params, labels, _, pp, _ = carried
    flat = _ref_flat(params)
    port_flat = flatten_paths(pp)
    assert list(port_flat) == list(flat)
    for path, arr in flat.items():
        np.testing.assert_array_equal(port_flat[path].numpy(), arr)
    assert T.model_labels(pp, cfg) == labels
    assert pp["blocks"]["attn"]["qkv"]["kernel"].shape[0] == cfg.num_layers
    assert pp["embed"]["tokens"].shape[0] == cfg.padded_vocab


@pytest.mark.parametrize("use_pallas", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("deploy", ["off", "analog_hw", "rtn", "digital_int4"])
def test_forward_logits_match_reference(carried, deploy, use_pallas):
    cfg = carried[0]
    rp, racfg, tp, tacfg = _deploy(carried, deploy)
    if deploy != "digital_int4":
        tacfg = dataclasses.replace(tacfg, use_pallas=use_pallas)
    toks = _tokens(cfg, 2, 12, seed=1)
    ref_logits, _, _ = ref_apply(rp, cfg, racfg, REF_EVAL,
                                 {"tokens": jnp.asarray(toks)})
    port_logits, stats, _ = port_apply(tp, cfg, tacfg, PORT_EVAL,
                                       {"tokens": torch.from_numpy(toks)})
    assert port_logits.dtype == torch.float32
    assert port_logits.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(port_logits.numpy(), np.asarray(ref_logits),
                               **TOL)
    assert stats["blocks"]["attn"]["qkv"]["x_std"].shape == (cfg.num_layers,)
    last, _, _ = port_apply(tp, cfg, tacfg, PORT_EVAL,
                            {"tokens": torch.from_numpy(toks)},
                            last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), port_logits[:, -1].numpy(),
                               **TOL)


@pytest.mark.parametrize("deploy", ["off", "digital_int4"])
def test_prefill_decode_equals_full_forward(carried, deploy):
    cfg = carried[0]
    _, _, tp, tacfg = _deploy(carried, deploy)
    b, s, sp = 2, 16, 12
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=2))
    full, _, _ = port_apply(tp, cfg, tacfg, PORT_EVAL, {"tokens": toks})
    caches = T.init_caches(cfg, b, s, device="cpu")
    pre, _, caches = port_apply(tp, cfg, tacfg, PORT_EVAL,
                                {"tokens": toks[:, :sp]}, caches=caches)
    assert caches["pos"] == sp
    errs = [float((pre - full[:, :sp]).abs().max())]
    for t in range(sp, s):
        lg, _, caches = port_apply(tp, cfg, tacfg, PORT_EVAL,
                                   {"tokens": toks[:, t:t + 1]},
                                   caches=caches, pos_offset=t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 5e-4, errs


@pytest.mark.parametrize("deploy", ["off", "analog_hw", "digital_int4"])
def test_greedy_generate_matches_reference_tokens(carried, deploy):
    cfg = carried[0]
    rp, racfg, tp, tacfg = _deploy(carried, deploy)
    prompt = _tokens(cfg, 3, 5, seed=3)
    num_new = 6
    ref_toks = ref_decode.generate(rp, cfg, racfg, jax.random.PRNGKey(4),
                                   jnp.asarray(prompt), num_new,
                                   greedy_first=num_new)
    gen = torch.Generator().manual_seed(4)
    port_toks = port_decode.generate(tp, cfg, tacfg, gen,
                                     torch.from_numpy(prompt), num_new,
                                     greedy_first=num_new)
    np.testing.assert_array_equal(port_toks.numpy(), np.asarray(ref_toks))


def test_sampled_generate_is_seeded(carried):
    cfg, _, _, _, tp, _ = carried
    acfg = port_analog.AnalogConfig(mode="off")
    prompt = torch.from_numpy(_tokens(cfg, 2, 4, seed=5))

    def run(seed):
        return port_decode.generate(
            tp, cfg, acfg, torch.Generator().manual_seed(seed), prompt, 5,
            temperature=0.8, top_k=20, top_p=0.9,
            cache_dtype=torch.bfloat16)

    a, b = run(0), run(0)
    assert a.shape == (2, 5) and torch.equal(a, b)
    assert int(a.max()) < cfg.vocab_size


def test_reference_checkpoint_loads_to_identical_arrays(carried, tmp_path):
    cfg, params, _, _, _, _ = carried
    path = ref_ckpt.save(str(tmp_path), 7, params)
    flat, manifest = load_reference_npz(path)
    assert manifest["step"] == 7
    tp = params_from_numpy(flat, "cpu")
    for p, arr in _ref_flat(params).items():
        np.testing.assert_array_equal(flatten_paths(tp)[p].numpy(), arr)
    # a corrupted array is refused by the port's own checksum
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["a0"] = arrays["a0"].copy()
    arrays["a0"].reshape(-1)[0] += 1.0
    bad = tmp_path / "bad.npz"
    np.savez(bad, **arrays)
    with pytest.raises(IOError):
        load_reference_npz(str(bad))


def test_module_wrapper_holds_the_tree_as_buffers(carried):
    cfg, _, _, _, pp, _ = carried
    model = AnalogLM(cfg, pp)
    sd = model.state_dict()
    assert set(sd) == {p.replace("/", ".") for p in flatten_paths(pp)}
    assert unflatten_paths(flatten_paths(model.params())).keys() == pp.keys()
    toks = torch.from_numpy(_tokens(cfg, 1, 6, seed=6))
    logits, _ = model(toks)
    ref, _, _ = port_apply(pp, cfg, model.acfg, PORT_EVAL, {"tokens": toks})
    torch.testing.assert_close(logits, ref, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_rope_and_gelu_mlp_match_reference(kind):
    """Layer pieces the reduced dense configs do not all reach: layernorm,
    the plain-GELU MLP (bias sites) and rope at offset positions."""
    from repro.models import layers as RL
    from repro_torch.models import layers as PL

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    np.testing.assert_allclose(
        PL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), kind).numpy(),
        np.asarray(RL.apply_norm(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), kind)), **TOL)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = (np.arange(5)[None] + np.array([[0], [9]])).astype(np.int32)
    np.testing.assert_allclose(
        PL.rope(torch.from_numpy(q), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(RL.rope(jnp.asarray(q), jnp.asarray(pos), 1e4)), **TOL)

    cfg = dataclasses.replace(get_config("granite-3-8b").reduce(), act="gelu")
    mp = RL.init_mlp(jax.random.PRNGKey(2), cfg)
    flat = _ref_flat(mp)
    y_ref, _ = RL.mlp(mp, jnp.asarray(x), cfg,
                      ref_analog.AnalogConfig(mode="off"), REF_EVAL)
    y_port, st = PL.mlp(params_from_numpy(flat, "cpu"), torch.from_numpy(x),
                        cfg, port_analog.AnalogConfig(mode="off"), PORT_EVAL)
    assert set(st) == {"up", "down"}
    np.testing.assert_allclose(y_port.numpy(), np.asarray(y_ref), **TOL)


def test_chunked_causal_attention_matches_reference():
    """The online-softmax path of prompts over 1024 tokens, at small chunk
    sizes so that chunks are ragged and future chunks get skipped."""
    from repro.models import layers as RL
    from repro_torch.models import layers as PL

    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 23, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 23, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 23, 2, 8)).astype(np.float32)
    ref = RL._chunked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), 0.35, q_chunk=5,
                                       kv_chunk=7)
    port = PL._chunked_causal_attention(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), 0.35,
                                        q_chunk=5, kv_chunk=7)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)
    # and it equals the dense causal path
    mask = torch.tril(torch.ones(23, 23, dtype=torch.bool))[None].expand(
        2, 23, 23)
    dense = PL._gqa_scores_softmax_v(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), mask, 0.35)
    np.testing.assert_allclose(port.numpy(), dense.numpy(), **TOL)


def test_sample_logits_edge_cases():
    from repro_torch.serve.sampling import sample_logits

    g = torch.Generator().manual_seed(0)
    logits = torch.randn(6, 50, generator=g)
    greedy = torch.argmax(logits, -1)
    assert torch.equal(sample_logits(g, logits, temperature=0.0), greedy)
    assert torch.equal(sample_logits(g, logits, greedy=True), greedy)
    assert torch.equal(sample_logits(g, logits, top_k=1), greedy)
    assert torch.equal(sample_logits(g, logits, top_p=1e-6), greedy)
    draws = sample_logits(g, logits, temperature=0.7, top_k=5)
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert bool((top5 == draws[:, None]).any(-1).all())

"""The port's continuous engine on the hybrid family (jamba-v0.1-52b,
reduced) against the JAX package's engine.

Weights and the hw noise instance of ``analog_hw`` are drawn by the
reference and carried across as numpy. The engines run the reference
scheduler tests' no-drop capacity, the reference's with
``prefix_cache=False`` (``tests/test_torch_prefix_state.py`` holds the
prefix cache) and one decode
step per engine step (its jitted steps compile once per deployment; a
greedy token does not depend on the decode block), the port's with its
default blocks of up to 8. Greedy tokens must be equal, paged and per-slot
contiguous; a request admitted mid-decode must give its solo tokens, and
a left-padded prompt the unpadded ``generate``'s (``tests/
test_scheduler.py``'s cases).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_hybrid import ref_model

from repro.configs import get_config
from repro.core import analog as RA
from repro.serve import scheduler as RS
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import analog as PA
from repro_torch.models import transformer as T
from repro_torch.serve import decode as port_decode
from repro_torch.serve import scheduler as PS

torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


@pytest.fixture(scope="module")
def carried():
    """(cfg, reference params / labels / hw instance, port params /
    instance)."""
    cfg = get_config(ARCH).reduce()
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    params, labels, inst = ref_model(cfg, 0)
    return (cfg, params, labels, inst,
            params_from_numpy(_ref_flat(params), "cpu"),
            params_from_numpy(_ref_flat(inst), "cpu"))


def _deploy(carried, deploy):
    """Reference (params, acfg) and port (params, acfg) of a deployment."""
    cfg, params, labels, inst, pp, pinst = carried
    plabels = T.model_labels(pp, cfg)
    if deploy == "analog_hw":
        return (RA.apply_noise_instances(params, labels, inst, "hw"),
                RA.AnalogConfig(mode="analog", train_noise=False),
                PA.apply_noise_instances(pp, plabels, pinst, "hw"),
                PA.AnalogConfig(mode="analog", train_noise=False))
    if deploy == "digital_int4":
        return (params, RA.AnalogConfig(mode="rtn", weight_bits=4),
                PA.pack_int4_weights(pp, plabels),
                port_decode.digital_int4_config(
                    PA.AnalogConfig(weight_bits=4)))
    return (params, RA.AnalogConfig(mode=deploy), pp,
            PA.AnalogConfig(mode=deploy))



def _prompt(cfg, n, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n).astype(np.int32)


def _churn(cfg):
    """More requests than slots, mixed lengths, mid-decode admission."""
    return [dict(uid=i, prompt=_prompt(cfg, 3 + i, seed=i),
                 max_new=4 + i % 3, temperature=0.0) for i in range(5)]


@pytest.mark.parametrize("deploy", ["off", "analog_hw", "digital_int4"])
def test_engine_matches_reference_paged_and_contiguous(carried, deploy):
    """Greedy tokens of the port's engine, paged and per-slot contiguous,
    equal the reference engine's; the paged engine allocates its pool for
    the attention leaves and returns every block."""
    cfg = carried[0]
    rp, racfg, tp, tacfg = _deploy(carried, deploy)
    reqs = _churn(cfg)
    geo = dict(num_slots=2, max_len=32, prefill_chunk=4, kv_block_size=4)
    want = RS.ServeEngine(rp, cfg, racfg, RS.SchedulerConfig(
        prefix_cache=False, decode_block=1, **geo)).run(
        [RS.Request(**r) for r in reqs])
    for paged in (False, True):
        eng = PS.ServeEngine(tp, cfg, tacfg, PS.SchedulerConfig(
            paged=paged, **geo))
        got = eng.run([PS.Request(**r) for r in reqs])
        assert sorted(got) == sorted(want)
        for uid in got:
            np.testing.assert_array_equal(got[uid], want[uid],
                                          err_msg=f"{uid} paged={paged}")
        assert (eng.pool is not None) == paged
        # the prefix cache, on by default, needs the paged pool
        assert set(eng.gating_reasons) == (set() if paged
                                           else {"prefix_cache"})
        if paged:
            pool = eng.pool
            assert pool.num_live == 0
            assert pool.num_free + pool.num_cached == pool.num_blocks


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_mid_decode_admission_parity(carried, paged):
    """A request admitted mid-decode into a busy batch (sampled path)
    produces exactly its solo tokens (``tests/test_scheduler.py``'s jamba
    case, both layouts)."""
    cfg, tp = carried[0], carried[4]
    acfg = PA.AnalogConfig(mode="off")
    scfg = PS.SchedulerConfig(num_slots=3, max_len=48, prefill_chunk=4,
                              decode_block=4, paged=paged, kv_block_size=4)
    target = PS.Request(uid=99, prompt=_prompt(cfg, 6), max_new=8,
                        temperature=0.9, top_k=17, top_p=0.95, seed=42)
    solo = PS.ServeEngine(tp, cfg, acfg, scfg).run([target])[99]
    eng = PS.ServeEngine(tp, cfg, acfg, scfg)
    for i in range(3):
        eng.submit(PS.Request(uid=i, prompt=_prompt(cfg, 3 + i, seed=i),
                              max_new=3 + 2 * i, temperature=1.1, seed=i))
    for _ in range(2):
        eng.step()
    eng.submit(target)
    out = eng.run()
    np.testing.assert_array_equal(solo, out[99])
    assert sorted(out) == [0, 1, 2, 99]
    assert eng.mixed_steps >= 1


def test_left_padded_prefill_matches_generate(carried):
    """``tests/test_scheduler.py``'s case: chunk 4, prompt 5 (3 left
    pads), the engine's greedy tokens equal the unpadded ``generate``."""
    cfg, tp = carried[0], carried[4]
    acfg = PA.AnalogConfig(mode="off")
    prompt = _prompt(cfg, 5)
    out = PS.ServeEngine(tp, cfg, acfg, PS.SchedulerConfig(
        num_slots=2, max_len=32, prefill_chunk=4)).run(
        [PS.Request(uid=0, prompt=prompt, max_new=6, temperature=0.0)])[0]
    want = port_decode.generate(tp, cfg, acfg, None,
                                torch.from_numpy(prompt[None]).long(), 6,
                                greedy_first=6)[0]
    np.testing.assert_array_equal(out, want.numpy())

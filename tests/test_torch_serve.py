"""The port's serving launcher end to end on the CPU (reduced configs).

``repro_torch.launch.serve.main`` builds the model, applies the deployment
and serves the mixed-length workload with the continuous engine (per-slot
contiguous, paged, or the int8 pool) or a batch with the static engine; on
the CPU every kernel runs its plain version, so the launch counters stay at
zero. The synthetic workload is the reference's, request for request.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import serve as ref_serve
from repro_torch.configs import get_config as port_get_config
from repro_torch.kernels import analog_matmul as k_analog
from repro_torch.kernels import int4_matmul as k_int4
from repro_torch.kernels import paged_attention as k_decode
from repro_torch.kernels import paged_prefill as k_prefill
from repro_torch.launch import serve

torch.set_num_threads(2)

BASE = ["--reduced", "--device", "cpu", "--engine", "static",
        "--num-requests", "3", "--new-tokens", "5"]


@pytest.mark.parametrize("arch", ["llama-3.2-1b", "phi-3-mini-4k"])
@pytest.mark.parametrize("deploy", ["analog_hw", "digital_int4"])
def test_static_serve_runs_on_cpu(arch, deploy, capsys):
    toks = serve.main(["--arch", arch, "--deploy", deploy, *BASE])
    assert toks.shape == (3, 5) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0
    assert int(toks.max()) < port_get_config(arch).reduce().vocab_size
    out = capsys.readouterr().out
    assert "[serve] static (cpu): 15 tokens" in out
    assert k_analog.launches == 0 and k_int4.launches == 0
    again = serve.main(["--arch", arch, "--deploy", deploy, *BASE])
    assert torch.equal(toks, again)                 # seeded end to end


@pytest.mark.parametrize("deploy", ["fp", "analog", "digital_rtn4"])
def test_other_deployments(deploy):
    toks = serve.main(["--deploy", deploy, "--cache-dtype", "f32", *BASE])
    assert toks.shape == (3, 5)


def test_noise_flags_are_validated():
    with pytest.raises(ValueError):
        serve.main(["--deploy", "analog", "--noise-model", "gaussian",
                    *BASE])
    toks = serve.main(["--deploy", "analog", "--noise-model", "gaussian",
                       "--noise-gamma", "0.02", *BASE])
    assert toks.shape == (3, 5)


def test_mixed_requests_match_reference():
    args = serve.parse_args(["--num-requests", "6", "--prompt-len", "12",
                             "--new-tokens", "32", "--seed", "3"])
    ours = serve.mixed_requests(args, port_get_config("llama-3.2-1b"))
    theirs = ref_serve.mixed_requests(args, get_config("llama-3.2-1b"))
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert (a.uid, a.max_new, a.temperature, a.top_k, a.seed) == \
            (b.uid, b.max_new, b.temperature, b.top_k, b.seed)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_engine_defaults_to_continuous_and_both_run_on_cpu(capsys):
    args = serve.parse_args([])
    assert args.engine == "continuous" and args.device == "cuda"
    assert (args.num_slots, args.prefill_chunk, args.kv_block_size) == (
        4, 8, 16)
    assert not args.paged and args.kv_bits == 0
    with pytest.raises(SystemExit):
        serve.parse_args(["--engine", "lockstep"])
    cont = serve.main(["--reduced", "--device", "cpu", "--num-requests", "3",
                       "--new-tokens", "5"])
    static = serve.main(BASE)
    assert sorted(cont) == [0, 1, 2] and static.shape == (3, 5)
    out = capsys.readouterr().out
    assert "[serve] continuous (cpu, contiguous kv, bf16)" in out
    assert "[serve] static (cpu): 15 tokens" in out


CONT = ["--reduced", "--device", "cpu", "--num-requests", "5",
        "--new-tokens", "6", "--num-slots", "2", "--prefill-chunk", "4"]


@pytest.mark.parametrize("kv", ["contiguous", "paged", "paged-int8"])
@pytest.mark.parametrize("deploy", ["analog_hw", "digital_int4"])
def test_continuous_serve_runs_on_cpu(deploy, kv, capsys):
    """The mixed workload through the continuous engine: every request
    gets its sampled budget, seeded end to end; ``--kv-bits`` implies
    ``--paged``; no kernel launches on the CPU."""
    flags = {"contiguous": [], "paged": ["--paged", "--kv-block-size", "4"],
             "paged-int8": ["--kv-bits", "8", "--kv-block-size", "4"]}[kv]
    before = (k_analog.launches, k_int4.launches, k_decode.launches,
              k_prefill.launches)
    res = serve.main(["--deploy", deploy, *CONT, *flags])
    reqs = serve.mixed_requests(serve.parse_args(CONT), port_get_config(
        "llama-3.2-1b").reduce())
    assert sorted(res) == [r.uid for r in reqs]
    for r in reqs:
        assert len(res[r.uid]) == r.max_new
        assert 0 <= res[r.uid].min() and res[r.uid].max() < 256
    out = capsys.readouterr().out
    assert f"[serve] continuous (cpu, {kv} kv, bf16)" in out
    assert "fused mixed steps" in out
    assert (k_analog.launches, k_int4.launches, k_decode.launches,
            k_prefill.launches) == before == (0, 0, 0, 0)
    again = serve.main(["--deploy", deploy, *CONT, *flags])
    for uid in res:
        np.testing.assert_array_equal(res[uid], again[uid])

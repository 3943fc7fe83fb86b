"""The port's serving launcher end to end on the CPU (reduced configs).

``repro_torch.launch.serve.main`` builds the model, applies the deployment
and serves a batch with the static engine; on the CPU every kernel runs its
plain version, so the launch counters stay at zero. The synthetic workload
is the reference's, request for request.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import serve as ref_serve
from repro_torch.configs import get_config as port_get_config
from repro_torch.kernels import analog_matmul as k_analog
from repro_torch.kernels import int4_matmul as k_int4
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


def test_engine_offers_static_only():
    with pytest.raises(SystemExit):
        serve.parse_args(["--engine", "continuous"])
    assert serve.parse_args([]).engine == "static"
    assert serve.parse_args([]).device == "cuda"

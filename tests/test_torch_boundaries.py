"""Guards of the port's boundaries.

* The port (``src/repro_torch``) and ``chip_smoke.py`` import neither JAX
  nor the reference package ``repro`` (an AST scan of every file).
* On CPU tensors the kernels' plain versions run and the launch counters
  stay at 0; a tensor on any other non-CUDA device is refused, not served
  by the plain version.
* Entry points that default to the card raise when there is none instead
  of running on the CPU.
"""

import ast
import os
import pathlib
import shutil

import pytest
import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels import analog_matmul as k_analog
from repro_torch.kernels import int4_matmul as k_int4
from repro_torch.kernels import paged_attention as k_decode
from repro_torch.kernels import paged_prefill as k_prefill
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as k_ssd
from repro_torch.launch import serve
from repro_torch.models import build
from repro_torch.models import model as model_mod

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _imports(path: pathlib.Path) -> list[str]:
    """Every module a file imports, statically or by a literal name."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names.append(node.args[0].value)
    return names


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert all(p.is_file() for p in PORT_FILES)
    port = ROOT / "src" / "repro_torch"
    for rel in ("kernels/paged_attention.py", "kernels/paged_prefill.py",
                "kernels/_paged.py", "kernels/csrc/paged_attention.cu",
                "kernels/csrc/paged_prefill.cu",
                "kernels/csrc/paged_common.cuh", "serve/kv_pool.py",
                "serve/scheduler.py", "kernels/ssd_scan.py",
                "kernels/csrc/ssd_scan.cu", "models/mamba2.py"):
        assert (port / rel).is_file(), rel


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_scan_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import quant\n"
                 "import importlib\nimportlib.import_module('repro.models')\n"
                 "from repro_torch.core import quant\n")
    assert [n for n in _imports(f) if _forbidden(n)] == [
        "jax.numpy", "repro.core", "repro.models"]


def test_cpu_tensors_run_the_plain_versions():
    before = (k_analog.launches, k_int4.launches)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 64, generator=g)
    w = torch.randn(64, 32, generator=g) * 0.1
    beta = torch.tensor([2.0])
    bound = ref.adc_bound(w, beta, 12.0)
    y = k_analog.analog_matmul(x, w, beta, bound)
    torch.testing.assert_close(y, ref.analog_matmul_ref(x, w, beta, bound),
                               rtol=0, atol=0)
    w_int = torch.randint(-7, 8, (64, 32), generator=g, dtype=torch.int8)
    scale = torch.rand(32, generator=g) + 0.1
    packed = ref.pack_int4(w_int)
    y4 = k_int4.int4_matmul(x, packed, scale)
    torch.testing.assert_close(y4, ref.int4_matmul_ref(x, packed, scale),
                               rtol=0, atol=0)
    dispatch.analog_mvm(x[None], w, beta, bound)
    dispatch.int4_mvm(x, w_int, scale)
    assert (k_analog.launches, k_int4.launches) == before == (0, 0)
    kp = torch.randn(5, 4, 2, 8, generator=g)
    tbl = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([5, 2], dtype=torch.int32)
    start = torch.tensor([1, 0], dtype=torch.int32)
    q = torch.randn(2, 4, 8, generator=g)
    out = k_decode.paged_flash_decode(q, kp, kp, tbl, pos, start, scale=0.3,
                                      num_splits=2)
    torch.testing.assert_close(out, ref.paged_decode_ref(
        q, kp, kp, tbl, pos, start, 0.3, num_splits=2), rtol=0, atol=0)
    qs = torch.randn(2, 3, 4, 8, generator=g)
    out = k_prefill.paged_flash_prefill(qs, kp, kp, tbl, pos, start,
                                        scale=0.3)
    torch.testing.assert_close(out, ref.paged_prefill_ref(
        qs, kp, kp, tbl, pos, start, 0.3), rtol=0, atol=0)
    assert (k_decode.launches, k_prefill.launches) == (0, 0)


def test_cpu_tensors_run_the_plain_ssd_scan():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 9, 4, 16, generator=g)
    dt = torch.rand(2, 9, 4, generator=g) * 0.1
    a = -torch.rand(4, generator=g)
    b = torch.randn(2, 9, 2, 16, generator=g)
    c = torch.randn(2, 9, 2, 16, generator=g)
    h0 = torch.randn(8, 16, 16, generator=g)
    for state in (None, h0):
        y, h = k_ssd.ssd_scan(x, dt, a, b, c, state)
        want = ref.ssd_scan_ref(x, dt, a, b, c, state)
        torch.testing.assert_close(y, want[0], rtol=0, atol=0)
        torch.testing.assert_close(h, want[1], rtol=0, atol=0)
        dispatch.ssd(x, dt, a, b, c, state)
    assert k_ssd.launches == 0


def test_other_devices_are_refused_not_served():
    x = torch.empty(2, 8, device="meta")
    w = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError):
        k_analog.analog_matmul(x, w, torch.empty(1, device="meta"),
                               torch.empty(4, device="meta"))
    with pytest.raises(ValueError):
        k_int4.int4_matmul(x, torch.empty(8, 2, dtype=torch.uint8,
                                          device="meta"),
                           torch.empty(4, device="meta"))
    pool = torch.empty(3, 4, 2, 8, device="meta")
    tbl = torch.empty(2, 2, dtype=torch.int32, device="meta")
    cur = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        k_decode.paged_flash_decode(torch.empty(2, 4, 8, device="meta"),
                                    pool, pool, tbl, cur, cur, scale=1.0)
    with pytest.raises(ValueError):
        k_prefill.paged_flash_prefill(torch.empty(2, 3, 4, 8, device="meta"),
                                      pool, pool, tbl, cur, cur, scale=1.0)
    gates = torch.empty(2, 3, 1, 16, device="meta")
    with pytest.raises(ValueError):
        k_ssd.ssd_scan(torch.empty(2, 3, 4, 16, device="meta"),
                       torch.empty(2, 3, 4, device="meta"),
                       torch.empty(4, device="meta"), gates, gates)


def _pool_args(**over):
    """Arguments of ``_paged.check_pool`` that pass, with ``over``
    replaced: a bf16 pool of 5 blocks of 4 tokens, 2 kv heads of 8, for 2
    rows of 4 query heads."""
    a = dict(kp=torch.zeros(5, 4, 2, 8, dtype=torch.bfloat16),
             vp=torch.zeros(5, 4, 2, 8, dtype=torch.bfloat16),
             k_scale=None, v_scale=None,
             tbl=torch.zeros(2, 3, dtype=torch.int32),
             pos=torch.zeros(2, dtype=torch.int32),
             start=torch.zeros(2, dtype=torch.int32),
             bsz=2, nq=4, hd=8, dev=torch.device("cpu"))
    a.update(over)
    return a


PAGED_REFUSALS = [
    "pool_dtype", "pool_rank", "v_mismatch", "gqa_ratio", "head_dim",
    "int8_without_scales", "scales_without_int8", "scale_dtype",
    "table_dtype", "table_rows", "cursor_dtype", "pool_strides"]


@pytest.mark.parametrize("case", ["dtype", "shape", "strides", "device"]
                         + [f"paged_{c}" for c in PAGED_REFUSALS])
def test_wrapper_argument_check_refuses(case):
    """What the kernel wrappers check before a launch on the card: every
    tensor (``_launch.check``), and the paged-attention wrappers' pool,
    scales, tables and cursors (``_paged.check_pool``)."""
    from repro_torch.kernels import _launch, _paged
    if not case.startswith("paged_"):
        t = torch.zeros(4, 6)
        _launch.check("t", t, torch.float32, (4, 6), t.device)
        bad = {"dtype": (t.double(), TypeError),
               "shape": (t[:3], ValueError),
               "strides": (t.t().contiguous().t(), ValueError),
               "device": (torch.zeros(4, 6, device="meta"),
                          ValueError)}[case]
        with pytest.raises(bad[1]):
            _launch.check("t", bad[0], torch.float32, (4, 6), t.device)
        return
    assert _paged.check_pool(**_pool_args()) == (5, 4, 2, 3, 1)
    i8 = torch.zeros(5, 4, 2, 8, dtype=torch.int8)
    sc = torch.zeros(5, 4, 2)
    assert _paged.check_pool(**_pool_args(kp=i8, vp=i8, k_scale=sc,
                                          v_scale=sc))[-1] == 2
    bad = {
        "pool_dtype": (dict(kp=torch.zeros(5, 4, 2, 8, dtype=torch.half),
                            vp=torch.zeros(5, 4, 2, 8, dtype=torch.half)),
                       TypeError),
        "pool_rank": (dict(kp=torch.zeros(5, 4, 16)), ValueError),
        "v_mismatch": (dict(vp=torch.zeros(5, 4, 2, 8)), TypeError),
        "gqa_ratio": (dict(nq=3), ValueError),
        "head_dim": (dict(hd=16), ValueError),
        "int8_without_scales": (dict(kp=i8, vp=i8), ValueError),
        "scales_without_int8": (dict(k_scale=sc, v_scale=sc), ValueError),
        "scale_dtype": (dict(kp=i8, vp=i8, k_scale=sc.double(),
                             v_scale=sc), TypeError),
        "table_dtype": (dict(tbl=torch.zeros(2, 3, dtype=torch.int64)),
                        TypeError),
        "table_rows": (dict(tbl=torch.zeros(3, 3, dtype=torch.int32)),
                       ValueError),
        "cursor_dtype": (dict(pos=torch.zeros(2, dtype=torch.int64)),
                         TypeError),
        "pool_strides": (dict(kp=torch.zeros(5, 2, 4, 8, dtype=torch.bfloat16
                                             ).transpose(1, 2)),
                         ValueError)}[case[len("paged_"):]]
    with pytest.raises(bad[1]):
        _paged.check_pool(**_pool_args(**bad[0]))


def test_cuda_launch_without_a_card_raises(monkeypatch, tmp_path):
    """A CUDA tensor never falls back to the plain version: without a card
    (and so without a built library) the launch path raises, and it does so
    before any build starts."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernels would launch")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")      # no CUDA tensor can even exist

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    for mod in (k_decode, k_prefill, k_ssd):
        mod._lib.cache_clear()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            mod._lib()
        mod._lib.cache_clear()
    assert not build_dir.exists()


def test_ssd_scan_on_a_cuda_tensor_without_a_card_raises(monkeypatch,
                                                         tmp_path):
    """``ssd_scan``'s launch path (its plan and its entry point) raises
    without nvcc instead of running the plain version, and builds nothing;
    the wrapper takes the launch path for any CUDA tensor."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel would launch")
    from repro_torch.kernels import _launch

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    _launch.ssd_plan.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _launch.ssd_plan(1, 32, 24, 64, 128, 1)
    k_ssd._lib.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k_ssd._lib()
    k_ssd._lib.cache_clear()
    _launch.ssd_plan.cache_clear()
    assert not build_dir.exists()
    assert k_ssd.launches == 0


def test_fused_dispatch_rules():
    assert dispatch.use_fused(AnalogConfig(mode="analog", use_pallas=True))
    assert dispatch.use_fused(AnalogConfig(mode="rtn", use_pallas=True))
    assert not dispatch.use_fused(AnalogConfig(mode="analog"))
    assert not dispatch.use_fused(AnalogConfig(mode="qat", use_pallas=True))
    assert not dispatch.use_fused(AnalogConfig(mode="analog", use_pallas=True,
                                               output_quant=False))
    assert dispatch.can_use_int4(64, 4) and not dispatch.can_use_int4(63, 4)
    assert not dispatch.can_use_int4(64, 8)


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--device", "cuda", "--reduced", "--num-requests", "1",
                    "--new-tokens", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--num-requests", "1", "--new-tokens", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build("llama-3.2-1b")
    with pytest.raises(RuntimeError):
        model_mod.default_device()


def test_kernel_build_setup():
    # the nvcc flags keep IEEE division and rintf: never fast math
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
    assert len(_build.SOURCES) == 5 and "ssd_scan" in _build.SOURCES
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
        assert path == _build.library_path(name)     # content-addressed
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "src/repro_torch/kernels/build/" in ignored
    has_nvcc = (shutil.which("nvcc") or os.path.isfile(
        "/usr/local/cuda/bin/nvcc") or os.environ.get("CUDA_HOME"))
    if has_nvcc:
        assert _build.find_nvcc()
    else:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()


def _run_chip_smoke(cwd: pathlib.Path):
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would drive it")
    proc = _run_chip_smoke(ROOT)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_the_port(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert "cannot import the port" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_kernels_line_sums_one_main_path_run():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.bound_ms(3.35e9, 1.0) == pytest.approx((1.0, "bytes"))
    assert cs.bound_ms(1.0, 67e9) == pytest.approx((1.0, "operations"))
    rows = {}
    for name in ("analog_matmul", "int4_matmul"):
        rows[name] = [
            {"site": site, "M": m, "col_off": False, "ms": 1.0,
             "wall_ms": 2.0, "plain_ms": 3.0, "matmul_ms": 4.0,
             "bound_ms": 0.5, "bound_by": "bytes" if m == cs.M_DECODE
             else "operations", "max_abs_err": 0.0}
            for site, _, _, _ in cs.SITES for m in (cs.M_DECODE, cs.M_PREFILL)]
        # mamba2-130m's shapes are timed in the same phase but belong to
        # another run: they must not enter llama's sums
        rows[name] += [
            {"arch": cs.MAMBA, "site": site, "M": m, "col_off": False,
             "ms": 100.0, "wall_ms": 100.0, "plain_ms": 100.0,
             "matmul_ms": 100.0, "bound_ms": 100.0,
             "bound_by": "operations", "max_abs_err": 0.0}
            for site, _, _, _ in cs.MAMBA_SITES
            for m in (cs.M_DECODE, cs.MAMBA_M_PREFILL)]
    paged = {}
    for name, kind in (("paged_flash_decode", "decode"),
                       ("paged_flash_prefill", "prefill")):
        paged[name] = [
            {"kind": kind, "context": c, "dtype": d, "splits": s,
             "rows": 8, "chunk": 1, "ms": 0.1 * c, "wall_ms": 0.2,
             "plain_ms": 3.0, "library_ms": 2.0, "bound_ms": 0.01,
             "bound_by": "bytes", "max_abs_err": 1e-7 * c}
            for c in cs.PAGED_CONTEXTS for d in cs.POOL_DTYPES
            for s in (cs.DECODE_SPLITS if kind == "decode" else (1,))]
    ssd = [{"case": name, "rows": b, "tokens": t, "h0": h0,
            "ms": 0.5 * t, "wall_ms": 0.6 * t, "plain_ms": 2.0 * t,
            "bound_ms": 0.01 * t, "bound_by": "operations",
            "max_abs_err": 1e-6 * t} for name, b, t, h0 in cs.SSD_CASES]
    line = cs.kernels_line(rows, {"analog_matmul": 7, "int4_matmul": 9},
                           paged, {"paged_flash_decode": 32,
                                   "paged_flash_prefill": 16}, ssd, 24 * 83)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    launches_per_run = cs.LAUNCHES_PER_FORWARD * cs.FORWARDS   # 65 x 17
    assert [k["name"] for k in line["kernels"]] == [
        "analog_matmul", "int4_matmul", "paged_flash_decode",
        "paged_flash_prefill", "ssd_scan"]
    for k in line["kernels"]:
        assert keys <= set(k)
        assert k["route"] == "cuda" and (ROOT / k["source"]).is_file()
        path, lineno = k["replaces"].split(":")
        assert "pallas_call" in (ROOT / path).read_text().splitlines()[
            int(lineno) - 1]
    for k in line["kernels"][:2]:
        assert k["ms"] == pytest.approx(launches_per_run)
        assert k["bound_ms"] == pytest.approx(0.5 * launches_per_run)
        assert k["bound_by"] == "bytes"          # 16 decode forwards
    for k in line["kernels"][2:4]:               # the named case
        assert k["case"]["context"] == 512 and k["case"]["dtype"] == "bf16"
        assert k["ms"] == pytest.approx(51.2)
        assert k["library_ms"] == 2.0
        assert k["max_abs_err"] == pytest.approx(2048e-7)
    scan = line["kernels"][4]                    # the engine's chunk
    assert scan["case"] == {"case": "chunk", "rows": cs.PREFILL_ROWS,
                            "tokens": cs.ENGINE_CHUNK, "h0": True}
    assert scan["ms"] == pytest.approx(16.0)
    assert scan["plain_ms"] == pytest.approx(64.0)
    assert scan["bound_by"] == "operations" and scan["library_ms"] is None
    assert scan["max_abs_err"] == pytest.approx(8192e-6)
    assert [k["launches"] for k in line["kernels"]] == [7, 9, 32, 16,
                                                        24 * 83]
    assert [k["path"] for k in line["kernels"]] == [
        "static/analog_hw", "static/digital_int4",
        "continuous/analog_hw/kv16", "continuous/analog_hw/kv16",
        "continuous/mamba2-130m/analog_hw"]

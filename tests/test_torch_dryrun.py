"""The port's dry-run tooling against the JAX package's: the meshes, the
training sharding rules as specs, the meta parameter tree, ``input_specs``,
one full-size cell of ``launch.dryrun`` and the memory table tool.

* Spec parity: for every config, at full width on both production meshes,
  the port's ``param_spec_tree`` and ``zero_spec_tree`` of its meta build
  equal the reference's of ``jax.eval_shape(init_model)`` leaf for leaf,
  and so does ``cache_spec_tree`` of the ``decode_32k`` inputs. The
  reference resolves them under ``jax.sharding.AbstractMesh``, as
  ``tools/kv_memory_table.py`` does. A reference ``PartitionSpec`` is
  compared as its tuple, a one-axis tuple as its name (``PartitionSpec``
  keeps it so); the port's host cursor ``pos`` (an int, spec ()) stands
  for the reference's replicated ``[L]`` cursor. The rules, ``resolve``
  and ``batch_spec_for`` too.
* Tree parity: the meta parameter tree has the reference's paths, shapes
  and dtypes.
* ``tools/kv_memory_table_torch.py`` prints ``tools/kv_memory_table.py``'s
  tables byte for byte.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_abstract_mesh
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as ref_shd
from repro.models import input_specs as ref_input_specs
from repro.models import transformer as RT
from repro_torch.configs import _MODULES, SHAPES, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import input_specs
from repro_torch.models import transformer as T

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(_MODULES)
META = torch.device("meta")
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}


def _ref_leaves(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in flat}


def _port_leaves(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_port_leaves(v, path + "/"))
        else:
            out[path] = v
    return out


def _tuple_axes(spec) -> tuple:
    """A spec with one mesh axis as its name and several as a tuple:
    ``PartitionSpec`` keeps ``("data",)`` as ``"data"``, the same
    sharding."""
    def one(a):
        if isinstance(a, (list, tuple)):
            return a[0] if len(a) == 1 else tuple(a)
        return a
    return tuple(one(a) for a in spec)


def _ref_specs(tree) -> dict:
    return {p: _tuple_axes(s) for p, s in _ref_leaves(
        tree, is_leaf=lambda s: isinstance(
            s, jax.sharding.PartitionSpec)).items()}


def test_meshes_need_no_device():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    assert make_host_mesh(2, devices=8).shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        make_host_mesh(3, devices=8)


@pytest.mark.parametrize("batch_shardable", [True, False])
def test_rules_resolve_like_the_reference(batch_shardable):
    """``default_rules``, ``resolve`` and ``batch_spec_for`` on both
    production meshes, guarded shapes included."""
    logical = [("batch", "seq", "heads", None), ("kv_seq", "mlp"),
               ("vocab", "embed"), ("experts", None, None), ("zero",)]
    shapes = [(256, 4096, 32, 128), (1, 100), (32000, 4096), (16, 8, 8),
              (48,)]
    for names, sizes in MESHES.values():
        rmesh = make_abstract_mesh(sizes, names)
        mesh = Mesh(names, sizes)
        kw = dict(batch_shardable=batch_shardable,
                  seq_shard_kv=not batch_shardable)
        ref_rules = ref_shd.default_rules(rmesh, **kw)
        rules = shd.default_rules(mesh, **kw)
        assert rules == ref_rules
        for lg, shape in zip(logical, shapes):
            with ref_shd.activate(rmesh, ref_rules):
                want = [_tuple_axes(ref_shd.resolve(lg)),
                        _tuple_axes(ref_shd.resolve(lg, shape)),
                        _tuple_axes(ref_shd.batch_spec_for(shape))]
            with shd.activate(mesh, rules):
                got = [_tuple_axes(shd.resolve(lg)),
                       _tuple_axes(shd.resolve(lg, shape)),
                       _tuple_axes(shd.batch_spec_for(shape))]
            assert got == want, (names, lg, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_tree_equal_the_reference(arch):
    """Parameter, ZeRO and decode-cache specs on both production meshes,
    and the meta parameter tree's shapes and dtypes."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    ref_params = jax.eval_shape(
        lambda: RT.init_model(jax.random.PRNGKey(0), rcfg)[0])
    params, _ = T.init_model(None, cfg, torch.float32, META)

    ref_tree = {p: (tuple(v.shape), str(v.dtype))
                for p, v in _ref_leaves(ref_params).items()}
    port_tree = {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                 for p, v in _port_leaves(params).items()}
    assert port_tree == ref_tree

    shape = SHAPES["decode_32k"]
    ref_caches = ref_input_specs(rcfg, REF_SHAPES["decode_32k"])["caches"]
    caches = input_specs(cfg, shape)["caches"]
    for names, sizes in MESHES.values():
        rmesh = make_abstract_mesh(sizes, names)
        mesh = Mesh(names, sizes)
        with ref_shd.activate(rmesh, ref_shd.default_rules(rmesh)):
            ref_p = _ref_specs(ref_shd.param_spec_tree(ref_params))
            ref_z = _ref_specs(ref_shd.zero_spec_tree(ref_params))
            ref_c = _ref_specs(ref_shd.cache_spec_tree(ref_caches))
        with shd.activate(mesh, shd.default_rules(mesh)):
            port_p = {p: _tuple_axes(s) for p, s in _port_leaves(
                shd.param_spec_tree(params)).items()}
            port_z = {p: _tuple_axes(s) for p, s in _port_leaves(
                shd.zero_spec_tree(params)).items()}
            port_c = {p: _tuple_axes(s) for p, s in _port_leaves(
                shd.cache_spec_tree(caches)).items()}
        assert port_p == ref_p, names
        assert port_z == ref_z, names
        assert port_c == ref_c, names
        # the decode cache's leaves themselves match (the cursor aside)
        port_cl = _port_leaves(caches)
        for p, v in _ref_leaves(ref_caches).items():
            if isinstance(port_cl[p], torch.Tensor):
                assert tuple(port_cl[p].shape) == tuple(v.shape), p


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["internvl2-2b", "musicgen-medium",
                                  "jamba-v0.1-52b"])
def test_input_specs_match_the_reference(arch, kind):
    """Tokens, labels, patch embeddings and the cache, on meta tensors."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    ref = ref_input_specs(rcfg, REF_SHAPES[kind], jnp.bfloat16)
    port = input_specs(cfg, SHAPES[kind], torch.bfloat16)
    want = {p: (tuple(v.shape), str(v.dtype))
            for p, v in _ref_leaves(ref).items()}
    got = {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for p, v in _port_leaves(port).items()
           if isinstance(v, torch.Tensor)}
    if kind == "decode_32k":
        # the port's cursors are host ints: the new token's position, and
        # the contiguous cache's write cursor
        assert port["pos"] == SHAPES[kind].seq_len - 1
        want = {p: v for p, v in want.items()
                if p != "pos" and not p.endswith("/pos")}
    assert got == want
    assert all(v.device.type == "meta" for v in _port_leaves(port).values()
               if isinstance(v, torch.Tensor))


def test_full_size_cell_runs_on_meta():
    """granite-3-8b ``decode_32k`` on the single production mesh: the
    whole cell at full width on the meta device."""
    rec = dryrun.run_cell("granite-3-8b", "decode_32k", "single")
    assert rec["status"] == "ok"
    cfg = get_config("granite-3-8b")
    mem = rec["memory"]
    # the KV cache [L, 128, 32768, KV, hd] bf16, batch on "data" and the
    # kv heads on "model" (8 of them do not divide 16: the sequence does)
    kv = 2 * cfg.num_layers * 128 * 32768 * cfg.num_kv_heads * cfg.head_dim
    assert mem["argument_size_in_bytes"] > 2 * kv // 256
    assert rec["analysis"]["flops"] > 2 * 128 * 7e9
    assert rec["analysis"]["collective_total_bytes"] is None
    assert rec["analysis"]["peak_bytes"] == mem["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("flags", [[], ["--tp", "4"]])
def test_kv_memory_table_matches_the_reference_tool(flags):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    outs = [subprocess.run([sys.executable, os.path.join(ROOT, "tools", t),
                            *flags], capture_output=True, text=True,
                           env=env, check=True, timeout=300).stdout
            for t in ("kv_memory_table.py", "kv_memory_table_torch.py")]
    assert outs[0] and outs[1] == outs[0]

"""The port's configs equal the reference's, field for field.

``repro_torch.configs`` keeps its own copy of the architecture registry (the
port imports nothing of ``repro``); this holds every architecture, its
``reduce()``d smoke config, their derived properties and the shape grid
against ``repro.configs``.
"""

import dataclasses

import pytest

from repro import configs as ref_configs
from repro_torch import configs as port_configs

NAMES = sorted(ref_configs._MODULES)


def test_registry_resolves_the_same_names():
    assert sorted(port_configs._MODULES) == NAMES
    assert port_configs.ARCH_NAMES == ref_configs.ARCH_NAMES
    with pytest.raises(KeyError):
        port_configs.get_config("no-such-arch")


def _derived(c):
    """Every derived property of a config, as plain values."""
    out = {"head_dim": c.head_dim, "padded_vocab": c.padded_vocab,
           "is_attention_free": c.is_attention_free}
    if c.ssm_headdim:
        out.update(ssm_heads=c.ssm_heads, d_inner=c.d_inner)
    out["layers"] = [(c.layer_kind(i), c.ffn_kind(i))
                     for i in range(c.num_layers)]
    return out


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference(name, reduced):
    ref = ref_configs.get_config(name)
    port = port_configs.get_config(name)
    if reduced:
        ref, port = ref.reduce(), port.reduce()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert _derived(port) == _derived(ref)


def test_shape_grid_matches_reference():
    assert ({k: dataclasses.asdict(v) for k, v in port_configs.SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in ref_configs.SHAPES.items()})
    assert port_configs.LONG_CONTEXT_ARCHS == ref_configs.LONG_CONTEXT_ARCHS
    for name in NAMES:
        for shape in ref_configs.SHAPES:
            assert (port_configs.shape_applicable(
                        port_configs.get_config(name),
                        port_configs.SHAPES[shape])
                    == ref_configs.shape_applicable(
                        ref_configs.get_config(name),
                        ref_configs.SHAPES[shape]))

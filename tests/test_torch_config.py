"""The port's configuration layer equals the reference's, field for field."""

import dataclasses

import pytest

from repro import configs as jconfigs
from repro.models import config as jconfig
from repro_torch import configs as tconfigs
from repro_torch.models import config as tconfig

ARCHS = list(jconfigs.ARCH_IDS)


def test_arch_ids_equal():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(tconfigs.all_configs()) == set(ARCHS)
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


def test_dataclasses_have_the_same_fields():
    for name in ("ModelConfig", "ShapeConfig"):
        jf = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(jconfig, name))]
        tf = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(tconfig, name))]
        assert jf == tf


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.q_per_kv == t.q_per_kv
    assert j.is_uniform() == t.is_uniform()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_pattern_equal(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert j.param_count() == t.param_count()
    assert j.layer_pattern() == t.layer_pattern()


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_equal(arch):
    j = jconfig.reduced(jconfigs.get_config(arch), vocab_size=64)
    t = tconfig.reduced(tconfigs.get_config(arch), vocab_size=64)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    assert j.layer_pattern() == t.layer_pattern()


def test_shape_cells_equal():
    assert [dataclasses.asdict(s) for s in jconfig.ALL_SHAPES] == \
           [dataclasses.asdict(s) for s in tconfig.ALL_SHAPES]
    assert set(tconfig.SHAPES_BY_NAME) == set(jconfig.SHAPES_BY_NAME)
    assert tconfig.TRAIN_4K.is_train and not tconfig.DECODE_32K.is_train


def test_post_init_checks():
    with pytest.raises(ValueError):
        tconfig.ModelConfig("x", "dense", 2, 64, 6, 4, 128, 32)
    with pytest.raises(ValueError):
        tconfig.ModelConfig("x", "moe", 2, 64, 4, 4, 128, 32)
    assert tconfig.ModelConfig("x", "dense", 2, 64, 4, 2, 128, 32).d_head == 16

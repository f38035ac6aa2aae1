"""The port's partition rules against the reference's, spec for spec.

Every arch id at its published width, on four meshes given as shape-only
stand-ins (``tests/test_sharding.py``'s ``_FakeMesh``): the production mesh
{data 16, model 16}, the multi-pod {pod 2, data 16, model 16}, and the
data-parallel meshes {data 4, model 1} and {data 8, model 1} this slice
trains on.  The port's parameters are its state dict on the meta device
(one entry a layer); each entry's spec equals the reference's spec of the
stacked leaf it belongs to with the leading stack axes (``None`` there)
dropped.  Caches (the port's layout: one Python-int ``pos``) and batches
(several batch sizes, divisible and not) are compared leaf for leaf, and
the placements of ``to_shardings`` follow the specs.
"""

import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.launch.specs import batch_specs as ref_batch_specs
from repro.models.model import build_model as ref_build
from repro.sharding import rules as ref_rules
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import specs
from repro_torch.sharding import rules


class _FakeMesh:
    """Shape-only stand-in (no process group, no devices)."""

    def __init__(self, sizes):
        self._sizes = sizes
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


MESHES = {
    "data16-model16": {"data": 16, "model": 16},
    "pod2-data16-model16": {"pod": 2, "data": 16, "model": 16},
    "data4-model1": {"data": 4, "model": 1},
    "data8-model1": {"data": 8, "model": 1},
}
CACHE_SHAPE = (32, 64)  # (batch, max_len)
BATCHES = (1, 2, 6, 8, 32, 256)


@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    cfg = ref_config(arch)
    bundle = ref_build(cfg)
    params = jax.eval_shape(bundle.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: bundle.init_cache(*CACHE_SHAPE))
    return params, cache


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict / tuple tree (spec tuples are leaves)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _flat(sub, prefix + (k,)).items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, (rules.PartitionSpec, jax.sharding.PartitionSpec)):
        return {p: v for i, sub in enumerate(tree) for p, v in _flat(sub, prefix + (i,)).items()}
    return {prefix: tree}


def _ref_path(port_key):
    """A port state dict key's reference path: stack indices dropped."""
    return tuple(k for k in port_key.split(".") if not k.isdigit())


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_equal_the_reference(arch, mesh_name):
    mesh = _FakeMesh(MESHES[mesh_name])
    cfg = get_config(arch)
    ref_params, ref_cache = _ref_trees(arch)

    # parameters: each port entry against its stacked reference leaf
    want = _flat(ref_rules.param_pspecs(ref_params, mesh))
    ref_leaves = _flat(ref_params)
    meta = specs.param_specs(cfg)
    got = rules.param_pspecs(meta, mesh)
    assert set(got) == set(meta)
    seen = set()
    for key, spec in got.items():
        path = _ref_path(key)
        ref_spec, ref_leaf = tuple(want[path]), ref_leaves[path]
        n_stack = len(ref_leaf.shape) - meta[key].ndim
        assert tuple(ref_leaf.shape[n_stack:]) == tuple(meta[key].shape), key
        assert ref_spec[:n_stack] == (None,) * n_stack, key
        assert isinstance(spec, rules.PartitionSpec) and spec == ref_spec[n_stack:], (key, spec, ref_spec)
        seen.add(path)
    assert seen == set(want), "reference leaves without a port entry"

    # the placements follow the specs, one per mesh dim
    from torch.distributed.tensor import Replicate, Shard

    for key, spec in got.items():
        placed = rules.to_shardings(spec, mesh)
        assert len(placed) == len(MESHES[mesh_name])
        for axis, pl in zip(MESHES[mesh_name], placed):
            dims = [d for d, e in enumerate(spec) if axis in rules._names(e)]
            assert pl == (Shard(dims[0]) if dims else Replicate()), (key, axis)

    # caches: every port leaf (pos aside) against the reference's
    cache_want = _flat(ref_rules.cache_pspecs(ref_cache, mesh))
    port_cache = specs.cache_specs(cfg, *CACHE_SHAPE)
    cache_got = _flat(rules.cache_pspecs(port_cache, mesh))
    port_leaves = _flat(port_cache)
    compared = 0
    for path, spec in cache_got.items():
        if path[-1] == "pos":
            assert spec == ()
            continue
        assert tuple(ref_cache_leaf_shape(ref_cache, path)) == tuple(port_leaves[path].shape), path
        assert spec == tuple(cache_want[path]), (path, spec, cache_want[path])
        compared += 1
    assert compared == sum(1 for p in cache_want if p[-1] != "pos")

    # batches: divisible and not, vlm patches and audio frames included
    for b in BATCHES:
        seq = cfg.vision_tokens + 16 if cfg.family == "vlm" else 16
        ref_b = ref_rules.batch_pspec(ref_batch_specs(ref_config(arch), seq, b), mesh)
        port_b = rules.batch_pspec(specs.batch_specs(cfg, seq, b), mesh)
        assert set(port_b) == set(ref_b)
        for k in port_b:
            assert port_b[k] == tuple(ref_b[k]), (b, k, port_b[k], ref_b[k])
            axes = rules.to_shardings(port_b[k], mesh)
            assert len(axes) == len(MESHES[mesh_name])


def ref_cache_leaf_shape(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return node.shape

"""The port's sharding rules equal the reference's, spec for spec: params,
decode state and inputs of every registered arch on the production meshes
and an elastic one, the logical-axis resolution, and the bridge from a
spec to DTensor placements.  The port's meshes are real ``DeviceMesh``es of
a virtual process group; the reference's spec functions read only a mesh's
axis names and shape, so JAX gets a stand-in of the same shape."""
import math
from contextlib import contextmanager

import numpy as np
import pytest
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro import sharding as jsh
from repro.core.config import ShapeConfig as JShapeConfig
from repro.core.config import get_arch as jget_arch
from repro.launch import mesh as jmesh
from repro.models import api as japi
from repro_torch import sharding as sh
from repro_torch.core.config import (LM_SHAPES, ShapeConfig, get_arch,
                                     list_archs)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api

PROD = {"256": ((16, 16), ("data", "model")),
        "512": ((2, 16, 16), ("pod", "data", "model"))}


class StandIn(AbstractMesh):
    """An abstract JAX mesh with the ``devices.shape`` the spec functions
    read."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=bool)


@contextmanager
def meshes(name):
    """(port mesh, JAX stand-in) of a production mesh ("256", "512") or of
    ``make_elastic_mesh(200)`` ("elastic"), the port's in a virtual group."""
    world = 200 if name == "elastic" else math.prod(PROD[name][0])
    with mesh_lib.virtual_group(world):
        if name == "elastic":
            mesh = mesh_lib.make_elastic_mesh(200)
            dims, axes = tuple(mesh.shape), ("data", "model")
        else:
            mesh = mesh_lib.make_production_mesh(multi_pod=name == "512")
            dims, axes = PROD[name]
        yield mesh, StandIn(dims, axes)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat(tree[k],
                                                     f"{prefix}/{k}").items()}
    return {prefix: tree}


def _jflat(tree):
    """JAX spec leaves as tuples (a ``PartitionSpec`` is no tuple)."""
    return {k: tuple(v) for k, v in _flat(tree).items()}


ARCHS = list_archs()


@pytest.mark.parametrize("name", ["256", "512", "elastic"])
def test_param_state_and_input_specs_equal_the_reference(name):
    with meshes(name) as (mesh, jm):
        assert tuple(mesh.shape) == tuple(jm.axis_sizes)
        for arch in ARCHS:
            jcfg, cfg = jget_arch(arch).model, get_arch(arch).model
            # the reference's shapes (the port's param tree is the same, key
            # for key, tests/test_torch_models.py); one trace of deepseek's
            # in the port takes ~25 s
            shapes = japi.param_shapes(jcfg)
            assert _flat(sh.param_pspecs(shapes, mesh)) == \
                _jflat(jsh.param_pspecs(shapes, jm)), arch
            for sname in get_arch(arch).shapes:
                shape, jshape = LM_SHAPES[sname], JShapeConfig(
                    sname, LM_SHAPES[sname].seq_len,
                    LM_SHAPES[sname].global_batch, LM_SHAPES[sname].mode)
                ins, jins = api.input_specs(cfg, shape), \
                    japi.input_specs(jcfg, jshape)
                if shape.mode != "decode":
                    port = mesh_lib.batch_shardings(cfg, ins, mesh)
                    ref = jmesh.batch_shardings(jcfg, jins, jm)
                    assert port == {k: tuple(v.spec) for k, v in ref.items()}
                    continue
                for sp in (True, False):
                    port = _flat(sh.state_pspecs(ins["state"], mesh, sp))
                    ref = _jflat(jsh.state_pspecs(jins["state"], jm, sp))
                    assert port == ref, (arch, sname, sp)
                assert sh.input_pspec(ins["tokens"].shape, ("batch",),
                                      mesh) == tuple(jsh.input_pspec(
                                          jins["tokens"].shape, ("batch",),
                                          jm).spec)


@pytest.mark.parametrize("name", ["256", "512"])
@pytest.mark.parametrize("logical,shape", [
    (("batch", "seq", "embed"), (256, 4096, 5120)),
    (("batch", "heads", "seq", None), (128, 40, 1, 128)),
    (("batch", "kv_heads", "kv_seq", None), (128, 8, 32768, 128)),
    (("batch", "seq", "vocab"), (32, 1, 152064)),
    (("batch", None, "embed"), (4, 1, 12)),
    (("none", "mlp"), (3, 13824)),
])
def test_spec_for_equals_the_reference(name, logical, shape):
    with meshes(name) as (mesh, jm):
        for strict in (False, True):
            assert sh.spec_for(logical, shape, mesh, strict) == \
                tuple(jsh.spec_for(logical, shape, jm, strict))


SIZES = {"data": 16, "model": 16}


@pytest.mark.parametrize("args,want", [
    (("heads", 40, SIZES, set(), False), "model"),
    (("heads", 40, SIZES, set(), True), None),
    (("heads", 32, SIZES, set(), True), "model"),
    (("heads", 8, SIZES, set(), False), None),
    (("batch", 64, {"pod": 2, "data": 16, "model": 16}, set(), True),
     ("pod", "data")),
    (("batch", 16, {"pod": 2, "data": 16, "model": 16}, set(), True),
     "data"),
])
def test_resolve_axis_cases(args, want):
    logical, dim, sizes, _, strict = args     # a fresh used-set each call
    assert sh._resolve_axis(logical, dim, sizes, set(), strict) == want \
        == jsh._resolve_axis(logical, dim, sizes, set(), strict)


def test_axis_used_once():
    used = set()
    assert sh._resolve_axis("heads", 32, SIZES, used) == "model"
    assert sh._resolve_axis("mlp", 32, SIZES, used) is None


def test_spec_to_placements_and_local_shards():
    with meshes("512") as (mesh, _):
        place = sh.placements((("pod", "data"), None, "model"), mesh)
        assert place == (Shard(0), Shard(0), Shard(2))
        assert sh.placements((None, "data"), mesh) == \
            (Replicate(), Shard(1), Replicate())
        # torch.chunk's uneven split: 40 heads on 16 ranks, 3 on rank 0,
        # 1 on rank 13, none on 14 and 15
        one = (Replicate(), Replicate(), Shard(1))
        assert sh.local_extent((8, 40, 128), one, mesh, (0, 0, 0)) == \
            ((8, 3, 128), (0, 0, 0))
        assert sh.local_extent((8, 40, 128), one, mesh, (0, 0, 13)) == \
            ((8, 1, 128), (0, 39, 0))
        assert sh.local_extent((8, 40, 128), one, mesh, (0, 0, 15))[0] == \
            (8, 0, 128)
        # a dim over (pod, data): pod-major, as the reference's spec
        assert sh.local_extent((128, 5), place[:2] + (Replicate(),), mesh,
                               (1, 3, 0)) == ((4, 5), (64 + 12, 0))


def test_virtual_group_refuses_a_second_group():
    with mesh_lib.virtual_group(4):
        with pytest.raises(RuntimeError, match="already"):
            with mesh_lib.virtual_group(4):
                pass



# the Mamba mixer's specs on a smoke mesh: (leaf, (2, 2)'s, (1, 4)'s)
MIXER = [("in_proj/w", ("data", "model"), (None, "model")),
         ("x_proj/w", ("data", "model"), (None, "model")),
         ("dt_proj/w", ("model", "data"), ("model", None)),
         ("out_proj/w", ("model", "data"), ("model", None)),
         ("dt_proj/b", ("model",), ("model",)),
         ("conv_w", (None, None), (None, None)),
         ("conv_b", (None,), (None,)),
         ("A_log", (None, None), (None, None)),
         ("D", (None,), (None,))]


@pytest.mark.parametrize("dims", [(2, 2), (1, 4)],
                         ids=lambda d: f"{d[0]}x{d[1]}")
def test_jamba_mixer_specs_equal_the_reference(dims):
    """jamba's smoke tree on ("data", "model") meshes of 4 ranks: its
    param and decode-state specs equal ``repro.sharding``'s of the same
    tree, leaf for leaf, and the mixer's are the expected ones: in_proj and
    x_proj (dt_rank 4 + 2 x d_state 8 = 20 outputs, 5 a rank on 4) column-
    parallel, dt_proj and out_proj row-parallel, dt_proj's bias on "model",
    the conv taps and bias, A_log and D replicated; the Mamba cache's conv
    window on ("batch", None, "mlp") and its state on ("batch", "mlp",
    None), as the mixer's u lies."""
    jcfg, cfg = jget_arch("jamba-1.5-large-398b").smoke, \
        get_arch("jamba-1.5-large-398b").smoke
    shapes = japi.param_shapes(jcfg)
    jm = StandIn(dims, ("data", "model"))
    with mesh_lib.virtual_group(math.prod(dims)):
        mesh = mesh_lib.make_elastic_mesh(4, model_parallel=dims[1])
        assert tuple(mesh.shape) == dims
        port = _flat(sh.param_pspecs(shapes, mesh))
        assert port == _jflat(jsh.param_pspecs(shapes, jm))
        col = 1 if dims == (2, 2) else 2
        for leaf, *want in MIXER:
            for sub in ("sub0", "sub1"):      # dense and MoE blocks
                assert port[f"/stack/periods/{sub}/ssm/{leaf}"] == \
                    (None,) + want[col - 1], leaf
        shape = JShapeConfig("d", 16, 4, "decode")
        ins = api.input_specs(cfg, ShapeConfig("d", 16, 4, "decode"))
        for sp in (True, False):
            state = _flat(sh.state_pspecs(ins["state"], mesh, sp))
            assert state == _jflat(jsh.state_pspecs(
                japi.input_specs(jcfg, shape)["state"], jm, sp))
            data = "data" if dims[0] > 1 else None
            assert state["/periods/sub0/ssm/conv"] == \
                (None, data, None, "model")
            assert state["/periods/sub0/ssm/state"] == \
                (None, data, "model", None)

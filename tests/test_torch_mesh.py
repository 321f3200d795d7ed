"""The device mesh of epgpy_torch (parallel/mesh.py) and the ten
atom-sharded kernel wrappers, on the CPU.

* ``make_mesh`` builds the shapes and axis names of JAX's
  (tests/test_parallel.py:16-19) and raises where it does: a shape that
  does not hold the devices; besides, a mesh of mixed device types, and
  ``make_mesh()`` with no CUDA device;
* each ``*_cuda_sharded`` wrapper on an 8-entry CPU mesh equals its
  unsharded call bitwise (every option of each on, 512 atoms);
* two of them, the FISP dictionary and the CPMG Jacobian, equal JAX's
  ``*_pallas_sharded`` in interpret mode on JAX's eight virtual CPU
  devices at the twin tolerance (2e-6 on signals, 1e-5 of each complex
  tangent column's scale; float32 both, another operation order), at
  the JAX tests' widths (tests/test_pallas.py:256-297, :387-413);
* ``fisp_mrf_dictionary(sharding=)`` and ``fisp_mrf_dictionary_sliced(
  sharding=)`` equal the unsharded calls, and JAX's sharded dictionary,
  to 1e-12 in float64 (tests/test_mrf.py:101-117).
"""

import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import chip_smoke
from epgpy_torch.models import cuda_fisp, slice_profile
from epgpy_torch.models.mrf import fisp_mrf_dictionary
from epgpy_torch.parallel import atom_sharding, make_mesh
from epgpy_tpu.models import mrf as jmrf
from epgpy_tpu.models import slice_profile as jslice
from epgpy_tpu.models.pallas_fisp import fisp_dictionary_pallas_sharded
from epgpy_tpu.models.pallas_mse import cpmg_jacobian_pallas_sharded
from epgpy_tpu.parallel import make_mesh as jax_make_mesh

from torch_support import port_f32, port_f64  # noqa: F401

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture
def jax_mesh8(cpu_devices):
    return Mesh(np.array(cpu_devices[:8]), ("atoms",))


def test_make_mesh_shapes_and_names(cpu_devices):
    mesh = make_mesh(CPU8, axes=("atoms", "tangents"), shape=(4, 2))
    jmesh = jax_make_mesh(cpu_devices, axes=("atoms", "tangents"),
                          shape=(4, 2))
    assert mesh.devices.shape == jmesh.devices.shape == (4, 2)
    assert mesh.axis_names == jmesh.axis_names == ("atoms", "tangents")
    assert mesh.shape == dict(jmesh.shape) == {"atoms": 4, "tangents": 2}
    # without a shape, every device goes on the first axis
    flat = make_mesh(CPU8, axes=("atoms", "tangents"))
    assert flat.devices.shape == jax_make_mesh(
        cpu_devices, axes=("atoms", "tangents")).devices.shape == (8, 1)
    assert all(d == torch.device("cpu") for d in flat.devices.flat)
    # entries along one axis sit at index 0 of the others
    assert mesh.entries("tangents", at={"atoms": 3}) == [
        mesh.devices[3, 0], mesh.devices[3, 1]]
    sh = atom_sharding(mesh)
    assert sh.mesh is mesh and sh.axis == "atoms"


def test_make_mesh_refusals(cpu_devices, monkeypatch):
    with pytest.raises(ValueError, match="device count"):
        make_mesh(CPU8, axes=("atoms", "tangents"), shape=(3, 2))
    with pytest.raises(ValueError):
        jax_make_mesh(cpu_devices, axes=("atoms", "tangents"), shape=(3, 2))
    with pytest.raises(ValueError, match="one device type"):
        make_mesh([torch.device("cpu"), torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="no axis"):
        atom_sharding(make_mesh(CPU8), axis="tangents")
    # make_mesh() takes the CUDA devices and never builds a CPU mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_atom_count_must_divide_the_axis(port_f32):
    args, kw = chip_smoke._tensors(torch, *chip_smoke.make_case(
        chip_smoke.OPTION_CASES[0], 12, 10), "cpu")
    with pytest.raises(ValueError, match="does not divide"):
        cuda_fisp.fisp_dictionary_cuda_sharded(*args, mesh=make_mesh(CPU8),
                                               **kw)


#: 512 atoms: 64 per shard, a multiple of every CPU vector width, so each
#: atom takes the same vectorized path in the sharded and the unsharded
#: twin.  (ATen runs a loop's remainder through the scalar op, whose libm
#: differs from the vector one in the last bit: at 8 atoms per shard the
#: twins differ by up to 7.8e-7 of an output's scale.)
WRAPPER_ATOMS, WRAPPER_N = 512, 12


@pytest.mark.parametrize("name", [w[0] for w in chip_smoke.MESH_WRAPPERS])
def test_sharded_wrapper_equals_unsharded(port_f32, name):
    case = next(c for c in chip_smoke.mesh_wrapper_cases(
        torch, WRAPPER_ATOMS, WRAPPER_N, "cpu", names=(name,)))
    want = case["plain"](*case["args"], **case["kw"])
    got = case["sharded"](*case["args"], mesh=make_mesh(CPU8), **case["kw"])
    want, got = (chip_smoke.tensor_leaves(x) for x in (want, got))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


def test_two_axis_mesh_shards_over_its_atom_axis(port_f32):
    """On an (atoms 4, tangents 2) mesh the atoms split four ways, the
    replicas along ``tangents`` computing nothing more."""
    case = next(c for c in chip_smoke.mesh_wrapper_cases(
        torch, 256, 8, "cpu", names=("fisp_half",)))
    mesh = make_mesh(CPU8, axes=("atoms", "tangents"), shape=(4, 2))
    got = case["sharded"](*case["args"], mesh=mesh, **case["kw"])
    want = case["plain"](*case["args"], **case["kw"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_fisp_dictionary_sharded_matches_jax(port_f32, jax_mesh8):
    P, B = 40, 64
    FA = np.linspace(10, 60, P)
    T1, T2 = np.linspace(300, 1500, B), np.linspace(30, 120, B)
    B1 = np.linspace(0.8, 1.2, B)
    jre, jim = fisp_dictionary_pallas_sharded(
        FA, 90.0, 12.0, 5.0, T1, T2, B1, mesh=jax_mesh8, nstate=4,
        btile=128, interpret=True)
    f32 = [torch.as_tensor(x, dtype=torch.float32) for x in (T1, T2, B1)]
    tre, tim = cuda_fisp.fisp_dictionary_cuda_sharded(
        FA, 90.0, 12.0, 5.0, *f32, mesh=make_mesh(CPU8), nstate=4)
    assert tre.shape == (B, P)
    for t, j in ((tre, jre), (tim, jim)):
        assert np.abs(t.numpy() - np.asarray(j)).max() < 2e-6


def test_cpmg_jacobian_sharded_matches_jax(port_f32, jax_mesh8):
    from epgpy_torch.models.cuda_mse import cpmg_jacobian_cuda_sharded

    necho, B = 8, 64
    rng = np.random.default_rng(3)
    FA = np.full(necho, 160.0)
    tau1, tau2 = rng.uniform(3, 6, necho), rng.uniform(3, 6, necho)
    T1, T2 = np.linspace(300, 1500, B), np.linspace(30, 120, B)
    B1 = np.linspace(0.7, 1.1, B)
    (jre, jim), (jdre, jdim) = cpmg_jacobian_pallas_sharded(
        (90.0, 90.0), FA, 0.0, tau1, tau2, T1, T2, B1, mesh=jax_mesh8,
        nstate=2 * necho, btile=64, interpret=True)
    f32 = [torch.as_tensor(x, dtype=torch.float32) for x in (T1, T2, B1)]
    (tre, tim), (tdre, tdim) = cpmg_jacobian_cuda_sharded(
        (90.0, 90.0), FA, 0.0, tau1, tau2, *f32, mesh=make_mesh(CPU8),
        nstate=2 * necho)
    assert tdre.shape == (B, necho, 3)
    for t, j in ((tre, jre), (tim, jim)):
        assert np.abs(t.numpy() - np.asarray(j)).max() < 2e-6
    # per tangent column, relative to the column's largest value (re and
    # im together: the imaginary parts are zero up to rounding)
    jd = np.asarray(jdre) + 1j * np.asarray(jdim)
    td = tdre.numpy() + 1j * tdim.numpy()
    scale = np.abs(jd).max(axis=(0, 1))
    assert (np.abs(td - jd).max(axis=(0, 1)) / scale).max() < 1e-5


def test_sharded_dictionaries_equal_unsharded(port_f64, cpu_devices):
    FAs = np.linspace(10, 60, 32)
    T1s, T2s = np.linspace(300, 1500, 16), np.linspace(30, 120, 16)
    sh = atom_sharding(make_mesh(CPU8))
    re0, im0 = fisp_mrf_dictionary(FAs, 12.0, 5.0, T1s, T2s, nstate=4)
    re1, im1 = fisp_mrf_dictionary(FAs, 12.0, 5.0, T1s, T2s, nstate=4,
                                   sharding=sh)
    jsh = NamedSharding(Mesh(np.array(cpu_devices[:8]), ("atoms",)),
                        PartitionSpec("atoms"))
    jre, jim = jmrf.fisp_mrf_dictionary(FAs, 12.0, 5.0, T1s, T2s, nstate=4,
                                        sharding=jsh)
    for a, b, j in ((re1, re0, jre), (im1, im0, jim)):
        assert a.dtype == torch.float64 and a.shape == (16, 32)
        assert np.abs(a.numpy() - b.numpy()).max() < 1e-12
        assert np.abs(a.numpy() - np.asarray(j)).max() < 1e-12
    # the slice-profile dictionary: 3 z points per atom, normalized
    kw = dict(scales=[0.8, 1.0, 0.9], weights=[0.25, 0.5, 0.25], nstate=4,
              normalize=True)
    s0 = slice_profile.fisp_mrf_dictionary_sliced(FAs, 12.0, 5.0, T1s, T2s,
                                                  **kw)
    s1 = slice_profile.fisp_mrf_dictionary_sliced(FAs, 12.0, 5.0, T1s, T2s,
                                                  sharding=sh, **kw)
    js = jslice.fisp_mrf_dictionary_sliced(FAs, 12.0, 5.0, T1s, T2s,
                                           sharding=jsh, **kw)
    for a, b, j in zip(s1, s0, js):
        assert np.abs(a.numpy() - b.numpy()).max() < 1e-12
        assert np.abs(a.numpy() - np.asarray(j)).max() < 1e-12

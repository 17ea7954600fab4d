"""Device-mesh and sharding helpers for the block-vector algebra.

The single scaling axis of this domain is the vector dimension ``n`` (the
problem size): block vectors are ``(m, n)`` arrays sharded over the mesh
along ``n`` (PartitionSpec(None, 'shards')).  Under ``jit`` XLA's SPMD
partitioner then turns every Gram/``dot`` contraction into a local GEMM
followed by a psum (an NCCL all-reduce between GPUs), and leaves linear
combinations local — the device equivalent of the "MPI Vectors" extension
point the reference names at core/solver.py:98-102.  ``make_mesh`` takes
``jax.devices()`` in order: the cards of one host are joined all to all
(NVLink), so the mesh follows the algorithm alone.
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = 'shards'
HOST_AXIS = 'hosts'


def make_mesh(n_devices=None, devices=None):
    """A 1-D mesh over ``n_devices`` (default: all available)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (AXIS,))


def make_mesh2d(hosts, chips_per_host, devices=None):
    """A 2-D ('hosts', 'shards') mesh for multi-host topologies.

    The vector dimension shards over BOTH axes (``blockvec_sharding``
    names every mesh axis), so Gram reductions become a two-stage psum:
    within a host over the inner (cards) axis and across hosts over the
    outer axis — the SURVEY §5.8 intra/inter-node split with no solver
    changes.  On a virtual CPU mesh both stages are plain collectives,
    which is what the multi-device dry-run validates."""
    if devices is None:
        devices = jax.devices()
    need = hosts * chips_per_host
    if len(devices) < need:
        raise ValueError('mesh %dx%d needs %d devices, have %d'
                         % (hosts, chips_per_host, need, len(devices)))
    grid = np.array(devices[:need]).reshape(hosts, chips_per_host)
    return Mesh(grid, (HOST_AXIS, AXIS))


def _vector_axes(mesh):
    """Every mesh axis, outermost first: the vector dimension shards over
    the full device grid whatever its rank."""
    names = tuple(mesh.axis_names)
    return names if len(names) > 1 else names[0]


def blockvec_sharding(mesh):
    """Sharding for (m, n) block-vector storage: split the vector dim
    over all mesh axes."""
    return NamedSharding(mesh, P(None, _vector_axes(mesh)))


def matrix_sharding(mesh):
    """Sharding for a dense (rows, features) data matrix: split features so
    operator applications contract over the sharded axis (psum over the
    mesh)."""
    return NamedSharding(mesh, P(None, _vector_axes(mesh)))


def replicated(mesh):
    return NamedSharding(mesh, P())

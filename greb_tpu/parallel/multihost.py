"""Multi-host execution support.

The reference is a single sequential process (SURVEY §2.4); here the
scaling path is `jax.distributed` + a global ('ens','y') mesh spanning all
hosts, with latitude-band domain decomposition (halo exchange between
devices, see parallel.halo) and per-host sharded I/O.

Pieces:
- ``initialize``        : jax.distributed bring-up (no-op on single host).
- ``global_mesh``       : an ('ens','y') mesh over ALL devices of all hosts.
- ``host_local_rows``   : the latitude rows this host's shards own.
- ``make_global_forcing``: build a globally-sharded forcing pytree where each
  host only materializes its own rows (jax.make_array_from_callback), so a
  768x384, 730-step forcing set (~3.2 GB) never fully lands on one host.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharded import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up jax.distributed.  With no arguments, uses the standard env
    vars (JAX_COORDINATOR_ADDRESS etc.) or stays single-process."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    elif coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address)


def global_mesh(n_ens: int = 1, n_y: Optional[int] = None) -> Mesh:
    """('ens','y') mesh over every device in the (multi-host) job."""
    devices = jax.devices()
    n_y = n_y if n_y is not None else len(devices) // n_ens
    return make_mesh(n_ens=n_ens, n_y=n_y, devices=devices)


def host_local_rows(mesh: Mesh, ydim: int) -> Tuple[int, int]:
    """[lo, hi) latitude-row range owned by this process's devices."""
    n_y = mesh.shape["y"]
    assert ydim % n_y == 0, (ydim, n_y)
    rows = ydim // n_y
    local = [d for d in mesh.devices.ravel()
             if d.process_index == jax.process_index()]
    ys = sorted({int(np.argwhere(mesh.devices == d)[0][-1]) for d in local})
    return ys[0] * rows, (ys[-1] + 1) * rows


def make_global_array(mesh: Mesh, spec: P, shape: Tuple[int, ...],
                      fill_local) -> jax.Array:
    """Globally-sharded array where each host materializes only its shards.

    ``fill_local(index_tuple) -> np.ndarray`` produces the data for one
    shard given its global index slices (called once per local shard).
    """
    sharding = NamedSharding(mesh, spec)

    def cb(index):
        a = np.asarray(fill_local(index))
        # NB: np.ascontiguousarray promotes 0-d to (1,) — keep scalars 0-d
        return np.ascontiguousarray(a) if a.ndim else a

    return jax.make_array_from_callback(shape, sharding, cb)


def make_global_forcing(mesh: Mesh, arrs: dict, y_axis: int = 1) -> dict:
    """Shard a forcing dict's (t, y, x) fields along 'y' across the mesh.

    Each host only touches the rows its devices own — pair with a row-ranged
    binary reader (io.binio.read_records + row slicing) for true sharded IO.
    """
    out = {}
    for k, a in arrs.items():
        a = np.asarray(a)
        if k in ("z_topo", "glacier"):
            spec = P("y", None)
        elif k == "sw_solar":
            spec = P(None, "y")
        else:
            spec = P(None, "y", None)
        out[k] = make_global_array(mesh, spec, a.shape,
                                   lambda idx, a=a: a[idx])
    return out

"""The multi-device layout of the port: a :class:`Grid` of ranks over
``torch.distributed`` in place of the reference's ``jax`` mesh
(``sharding/logical.py``, ``launch/mesh.py``, ``compat.py``)."""
from repro_torch.sharding.grid import (CLIENT_AXES, INNER_AXES, RULES_DP,
                                       Grid, RecordingGrid,
                                       client_scalar_spec, free_port,
                                       init_local_group, make_host_grid,
                                       round_specs, spec_for, tree_specs)

__all__ = ["CLIENT_AXES", "INNER_AXES", "RULES_DP", "Grid", "RecordingGrid",
           "client_scalar_spec", "free_port", "init_local_group",
           "make_host_grid", "round_specs", "spec_for", "tree_specs"]

"""The dry run of the production meshes (counterpart of the JAX package's
``launch/dryrun.py``, an XLA compile of every shape cell over 512 forced
devices). Not ported: it needs item 11's shape cells and input specs, and
the port has no compiler that lays a step out over a mesh it does not run
on. `main` raises `NotImplementedError` naming ROADMAP item 10."""
from __future__ import annotations


def main(argv=None):
    raise NotImplementedError(
        "launch/dryrun.py waits for ROADMAP item 10 (with item 11's "
        "SHAPE_CELLS and input_specs)")


if __name__ == "__main__":
    main()

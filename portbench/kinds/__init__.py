"""The traffic kinds, one module each, found by the kind's name
(`harness/cell.py:kind_module`). Each has ``inputs(config, traffic, g,
device)``, the pool made from the seed's generator, and ``drive(cell,
spec, tree, load, seed, seconds, traced, device, t_start, regions, hooks,
out)``, which builds the timed path, warms it, runs the window and fills
``out`` (a `harness/cell.py:Outcome`): the end-to-end metrics, the run
the per-layer readers read, and the check's numbers."""

"""One reader a per-layer metric: ``<metric>.py`` exposes ``read(ctx)``,
the metric's value from a traced run's context, or None where the run
holds nothing for it to read.  The context: ``window``
(``yardstick.Window``), ``config``, ``traffic``, ``param_shapes``,
``peak_bytes`` and the driver's counts of the window's work (the
simulator's ``events``, ``worker_steps`` and ``active_sum``, the lanes
that took a gradient; training's ``steps`` and ``tokens``)."""

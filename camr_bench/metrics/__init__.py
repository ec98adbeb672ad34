"""One reader per metric, ``<name>.py``, found by the metric's name in
``BENCHMARK.json``. Each defines ``read(ctx)``, which returns the
metric's value from the run's context (:class:`camr_bench.bench.Context`)
or ``None`` where the run has nothing to read it from; a metric read as
``None`` is left out of the result's line."""

"""The benchmark's drivers, one file each, found by the ``driver`` that a
traffic mix names (``ecbench/traffic/<mix>.json``). Each holds a class
``Driver(job)`` with ``setup()``, ``window(run)``, ``drop()`` and
``answers()`` (``ecbench/harness.py``)."""

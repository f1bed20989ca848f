"""The package's entry points a cell can drive, one module an entry, named
by the traffic file's ``entry`` (see :mod:`gpubench.harness.cell`)."""

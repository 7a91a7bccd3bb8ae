"""The harness: finding the parts by name, one run of a cell, the trace's
reduction, the no-JAX guard."""

"""FFCz core: dual-domain error bounding via alternating projection (paper §IV).

Modules: ``bounds``, ``cubes``, ``spectrum`` (math on tensors), ``pocs`` (the
loop), ``engine`` (PLAN / EXECUTE / ENCODE), ``ffcz`` (the codec and its wire
format), ``edits`` and ``errors``.  Nothing is re-exported here, so the
kernels can import ``core.cubes`` without importing the engine.
"""

"""Native (C++) host-side components, loaded via ctypes with pure-Python
fallbacks: the port's copy of the JAX package's ``native`` package, for the
grammar token-table builder (``csrc/fsm.cpp``, ``native/fsm.py``). See
``native/build.py`` for the build and load logic."""

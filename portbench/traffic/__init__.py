"""The laws a workload file's traffic is drawn by, one file a law,
found by name: ``<role>_<law>.py`` for the role ``sizes``, ``points`` or
``masses`` (``lib/gen.py``)."""

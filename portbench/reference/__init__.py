"""The plain references: plain NumPy or plain torch. A reference
imports nothing of the program under test, nor JAX, nor the benchmark's
own ``entries`` or ``lib``, and works everything out from the inputs the
benchmark made. A configuration names its module here under
``"reference"``; the module's ``check(instance, answer, config)`` gives
the numbers that one answer is held to."""

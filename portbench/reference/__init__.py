"""The plain reference: NumPy only. It imports nothing of the program
under test, nor JAX, and works everything out from the inputs the
benchmark made. A configuration names its module here under
``"reference"``."""

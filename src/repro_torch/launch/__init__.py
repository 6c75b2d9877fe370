"""Device selection and mesh builders of the port (``platform``, ``mesh``).

Importing these modules touches no device: every builder is a function.
"""

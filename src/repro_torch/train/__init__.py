"""Training of the port: the step (``train.train_step``) and the
fault-tolerant loop (``train.trainer``)."""

"""Optimizers of the port: AdamW, Adafactor, the cosine schedule,
global-norm clipping and int8 error-feedback compression
(``optim.optimizer``)."""

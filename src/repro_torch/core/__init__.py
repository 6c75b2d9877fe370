"""Solver core of the port: matching, the stepped push-relabel cores for
assignment and OT, the problem specs, the batch drivers and the ``solve``
front door. Every function works on a batch axis written out in front."""

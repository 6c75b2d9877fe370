"""Entries: how a cell drives the program through its window."""

"""Experiment tools of the port."""

"""Estimators of a step's time from its counted cost (twin of
``repro.core.estimator``; only the roofline is ported)."""

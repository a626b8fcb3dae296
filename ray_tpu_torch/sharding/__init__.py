"""Learner-plane scheduling: the K-update superstep (``superstep.py``)."""

"""Roofline analysis of the dry-run's traced steps (torch); counterpart of
``repro.roofline``, over the H100's constants."""

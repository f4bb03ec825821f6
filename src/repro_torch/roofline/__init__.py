"""The roofline: per-rank cost counting, its analysis and report."""

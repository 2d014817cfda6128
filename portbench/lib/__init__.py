"""The harness's own parts: the registry of files by name, the traced
window, the comparison, and what the metric readers share."""

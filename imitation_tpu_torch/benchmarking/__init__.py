"""Statistics for comparing algorithms over seeds (``summarize``)."""

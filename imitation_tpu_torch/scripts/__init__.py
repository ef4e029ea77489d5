"""The command-line scripts: ``python -m imitation_tpu_torch <script> ...``."""

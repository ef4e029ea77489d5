"""Data-parallel training across processes (``distributed``) and the
placement of the learners' states over them (``mesh``)."""

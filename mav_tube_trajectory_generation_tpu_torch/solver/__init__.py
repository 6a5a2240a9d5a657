"""Solvers: closed-form linear QP, banded factors, tube-constrained QCQP."""

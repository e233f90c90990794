"""The plain references the benchmark judges the port against.

Plain Python and NumPy. Nothing here imports the port, the JAX package or
JAX: each reference works from the inputs the benchmark made (the
configuration's numbers, the generated pods and nodes) and reads the
port's outputs only to judge them.
"""


class OutOfScope(Exception):
    """The inputs need a decision this reference does not make."""

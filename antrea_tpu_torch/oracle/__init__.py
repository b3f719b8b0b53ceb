"""The scalar policy interpreter (interpreter.py, a copy of the JAX
package's), which the commit plane's canary holds the engine to."""

from .interpreter import Oracle, DirectionVerdict, Verdict, VerdictCode  # noqa: F401

"""The scalar policy interpreter (interpreter.py, a copy of the JAX
package's), which the commit plane's canary holds the engine to, and the
scalar pipeline of the twin engine (pipeline.py, hashing with the numpy
copy hashing.py; datapath/oracle_dp.py drives it)."""

from .interpreter import Oracle, DirectionVerdict, Verdict, VerdictCode  # noqa: F401

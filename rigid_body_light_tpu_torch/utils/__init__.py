"""Utilities of the port: configuration checks that run on the host
(:mod:`.validation`), the FP32 peak probe (:mod:`.roofline`), the
checkpoint reader (:mod:`.checkpoint`) and the step timer and traces
(:mod:`.profiling`)."""

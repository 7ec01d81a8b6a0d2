"""Utilities of the port: configuration checks that run on the host
(:mod:`.validation`) and the FP32 peak probe (:mod:`.roofline`)."""

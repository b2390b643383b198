"""Distributed pieces of the port: fault tolerance (:mod:`.fault`) and the
serving half of the sharding rules (:mod:`.sharding`)."""

"""Sharded decode and encode over a (dp, sp) mesh of torch devices
(``parallel.sharded``)."""

"""Routing IR, fault state and the plan-keyed dispatcher of the port."""

"""Federated-learning layer of the port: strategies, round engine, LM
tasks."""

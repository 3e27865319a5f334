"""Service layer of the port: request parameters and the generation entry."""

"""The closed-loop clients: how a job is submitted to the program, one module a
kind of deployment."""

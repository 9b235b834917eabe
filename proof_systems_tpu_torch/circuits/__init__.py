"""The circuit layer of the port: gates, the bench circuit, the constraint
system, the constraint expressions and their evaluation over d8."""

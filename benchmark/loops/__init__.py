"""Loops: one per kind of traffic, each a general generator of timed units
that a traffic file parameterises (`"loop": "<module>"`)."""

"""Device operations of the port: hashing, profiles, the screen, exact
ANI and greedy selection."""

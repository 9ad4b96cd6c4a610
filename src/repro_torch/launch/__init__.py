"""Cell assembly: the entry points that return a runnable step."""

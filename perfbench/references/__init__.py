"""Plain references, one a configuration family, named by a configuration file's ``reference`` key."""

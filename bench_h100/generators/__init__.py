"""General traffic generators; each reads the parameters of a mix file."""

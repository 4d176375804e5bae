"""The relational engine: FRA IR (fra, keys), relations, the interpreter
oracle, RA auto-diff, the rewrite stage, the chunked compiler with its
kernel dispatch registry, the staged engine and the Database session."""

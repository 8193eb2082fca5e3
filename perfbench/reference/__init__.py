"""Plain fp32 references, one file per model family; none imports the port."""

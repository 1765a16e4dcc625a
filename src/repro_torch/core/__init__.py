"""IGD primitives, the UDA fold, orderings, stop rules and the build counter."""

"""Model layer of the port: parameter specs and the dense building blocks."""

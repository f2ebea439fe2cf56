"""Plain f32 references of the models the port serves, written from the
published modeling code alone: they import neither JAX nor the JAX package
nor the port, so a test can hold either package to them."""

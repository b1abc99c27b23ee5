"""Found by name by gan_bench.run."""

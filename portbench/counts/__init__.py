"""Operations and bytes from shapes: the kernels' least times and the
model's FLOPs per image. Frozen with the benchmark."""

"""Host (NumPy) reference pieces the port needs beside its tensors."""

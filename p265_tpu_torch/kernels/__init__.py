"""Device side of Stage B: the kernels' wrappers and their plain versions;
`staging` moves a dispatch's host arrays to the device."""

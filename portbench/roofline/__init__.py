"""The yardstick's frozen arithmetic: the chip's published peaks, the
least time a kernel's inputs need, and how the port's kernels show in a
device trace."""

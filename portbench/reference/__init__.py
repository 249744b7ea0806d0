"""The plain reference: float64 MPS energies and canonical forms, the
Hamiltonians' own MPOs, exact energies, a plain one-site DMRG sweep, and
the comparison that decides ``correct``.  Plain PyTorch and NumPy; it
imports nothing of the port and takes nothing the port made but the
outputs it judges."""

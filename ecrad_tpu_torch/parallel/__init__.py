"""Column blocks, columns split over devices, several processes, and the
scaling benchmark."""

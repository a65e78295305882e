"""Planners: robot surface model, IK screen, goal-set trajectory planner."""

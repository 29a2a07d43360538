"""Logical planning: plan nodes, planner, optimizer, fragmenter.

Analog of the reference's sql/planner package: LogicalPlanner.java:195
builds the node DAG, PlanOptimizers.java runs the rule pipeline,
PlanFragmenter.java:108 cuts at remote exchanges.
"""
